"""wav2vec2-base and the classifier in PyTorch (eval mode), with weight converters."""
