"""Distributed-systems layer of the port. Port of ``repro.distributed``:
so far ``checkpoint`` (atomic versioned save and restore); faults,
resume and stragglers are ROADMAP A12, elastic multi-device A13."""
