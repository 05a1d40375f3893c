"""Hand-written Hopper kernels (sources in ``../../csrc``), each beside its plain version."""
