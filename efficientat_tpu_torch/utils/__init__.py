"""Train-state checkpoints and exported weights (``utils.checkpointing``)."""
