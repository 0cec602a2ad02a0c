"""Train-side modules of the port; this slice holds the predict forward
(train/predict.py)."""
