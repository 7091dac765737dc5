"""Seeded lint fixture (never imported): a kernel wrapper that falls back
to its plain version when the kernel fails, and a handler whose only
raise sits in a nested function (not a re-raise). Two X001; the handler
that re-raises and the library call (under kernels/) are fine."""
from repro_torch.kernels import _build


def plain(x):
    return x


def wrapper(x):
    try:
        return _build.library().run(x)
    except RuntimeError:
        return plain(x)


def strict(x):
    try:
        return _build.library().run(x)
    except RuntimeError as e:
        raise RuntimeError(f"kernel failed: {e}") from e


def nested(x):
    try:
        return plain(x)
    except ValueError:
        def later():
            raise ValueError("not a re-raise of this handler")
        return later
