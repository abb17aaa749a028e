"""Audio-token vocabulary mapping (own copy of the JAX package's ``vocab/``)."""
