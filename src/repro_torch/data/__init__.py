"""The training data stream (``data.pipeline``)."""
