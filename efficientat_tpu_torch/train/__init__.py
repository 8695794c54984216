"""Training: the train and eval steps, augmentations, schedules, task
presets, the KD teacher store, metrics and the ``train`` / ``evaluate``
drivers (port of efficientat_tpu/train/)."""
