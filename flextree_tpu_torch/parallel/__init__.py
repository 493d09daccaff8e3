"""Training on one card: the train step, the run loop and the attention
switch (the single-device half of the JAX package's
``flextree_tpu.parallel``).  Import by module path."""
