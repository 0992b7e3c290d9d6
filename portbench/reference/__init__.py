"""The plain reference that decides a run's ``correct``: plain PyTorch in
the parameters' dtype (f32, TF32 off, for the check), written from the
papers.  Nothing here imports the program, the JAX package or JAX."""
