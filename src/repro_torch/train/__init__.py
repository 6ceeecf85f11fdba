"""Serve steps of the LM substrate (training waits: ROADMAP queue 1 item
12), and the snapshots and fault injection of the resumable GPIC
supervisor (``checkpoint``, ``fault_tolerance``)."""
