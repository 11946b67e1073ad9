"""Parameter specs and the device env the model code runs under. One card
for now: the multi-device mesh waits for its own slice (``ROADMAP.md``)."""
