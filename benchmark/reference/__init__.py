"""The plain PyTorch reference that decides ``correct``. It imports
neither JAX, the JAX package nor anything of the program."""
