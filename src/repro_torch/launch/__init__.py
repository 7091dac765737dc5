"""Launchers. Port of ``repro.launch`` (``serve`` only; ``train`` waits for
ROADMAP A17's second part, ``dryrun``, ``hlo_analysis`` and ``mesh`` for
A19)."""
