"""nd namespace: NDArray over torch.Tensor, and mxtpu's file format."""
from .ndarray import (NDArray, array, host_copies, load, save, to_numpy,
                      zeros)

__all__ = ["NDArray", "array", "zeros", "to_numpy", "host_copies", "save",
           "load"]
