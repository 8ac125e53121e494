"""mx.image: host-side image decode and augmentation.

Counterpart of ``mxtpu/image/`` (parity: python/mxnet/image/:
image.py's ImageIter and augmenter chain, detection.py's ImageDetIter).
Decoding and augmentation run on the host with cv2 and numpy, as in the
reference; the card sees only assembled batches.
"""
from .image import *  # noqa: F401,F403
from . import detection  # noqa: F401
from .detection import (CreateDetAugmenter,  # noqa: F401
                        CreateMultiRandCropAugmenter, ImageDetIter)
