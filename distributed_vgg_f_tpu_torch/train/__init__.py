"""Train-side modules of the port: the predict forward (train/predict.py),
the schedule and optimizer (train/schedule.py), the train state
(train/state.py), the single-device train and eval steps (train/step.py),
the core loop (train/trainer.py) and the distillation tool that makes
the serving student's weights (train/distill.py)."""
