"""Audio helpers: z-normalisation, WAV reading, resampling, and the train-time
augmentation chain with its noise bank."""
