"""Shared constants (counterpart of gdm_tpu/constants.py)."""

import numpy as np

# torchvision-pretrained normalisation (reference utils/ply.py:502-509)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
