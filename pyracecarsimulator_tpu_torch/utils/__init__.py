from .checkpoint import save_npz, load_npz, save_pytree, load_pytree
