"""wav2vec2-base and the classifier in PyTorch, the diffusion vocoders and their registry,
with weight converters."""
