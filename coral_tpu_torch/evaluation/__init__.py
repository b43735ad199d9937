"""Loading a predictor for evaluation and serving."""
