"""Fault tolerance: straggler detection, preemption handling and elastic
re-meshing policies (``ft.resilience``)."""
