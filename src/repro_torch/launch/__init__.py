"""Launchers. Port of ``repro.launch`` (``serve`` and ``mesh``; ``train``
waits for ROADMAP A17's second part, ``dryrun`` and ``hlo_analysis`` for
A19)."""
