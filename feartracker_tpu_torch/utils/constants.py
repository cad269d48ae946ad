"""Output keys and normalization constants (copied from
``feartracker_tpu/utils/constants.py``, which the port does not import)."""

TARGET_CLASSIFICATION_KEY = "TARGET_CLASSIFICATION_KEY"
TARGET_REGRESSION_LABEL_KEY = "TARGET_REGRESSION_LABEL_KEY"

# ImageNet normalization used throughout the reference
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
