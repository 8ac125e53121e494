"""nd namespace: NDArray over torch.Tensor."""
from .ndarray import NDArray, array, to_numpy, zeros

__all__ = ["NDArray", "array", "zeros", "to_numpy"]
