"""AdamW (``training.optimizer``) and the train step with gradient
accumulation (``training.trainer``)."""
