"""The benchmark's plain references: plain Python integers only.  Nothing
here imports the program under test, JAX or the JAX package."""
