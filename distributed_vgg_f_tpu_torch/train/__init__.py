"""Train-side modules of the port: the predict forward (train/predict.py),
the schedule and optimizer (train/schedule.py), the train state
(train/state.py), the single-device train and eval steps (train/step.py)
and the core loop (train/trainer.py)."""
