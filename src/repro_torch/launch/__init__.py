"""Launchers. Port of ``repro.launch`` (``serve``, ``train`` and
``mesh``; ``dryrun`` and ``hlo_analysis``, the TPU launch tools, wait for
ROADMAP A19)."""
