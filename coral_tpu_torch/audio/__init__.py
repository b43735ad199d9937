"""Audio helpers of the serving path: z-normalisation, WAV reading, resampling."""
