"""Model setup (the serving half of the JAX package's ``training/model_setup.py``)."""
