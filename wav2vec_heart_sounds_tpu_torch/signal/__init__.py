"""Signal processing on device tensors (the PyTorch twin of ``signal/jaxproc.py``)."""
