"""Data layer of the port (counterpart of unet_tpu/data/): folder datasets,
augmentation and batching, host numpy and cv2. `labelme` conversion, which
only `cli tools` uses, is ROADMAP A14b."""
from unet_tpu_torch.data.dataset import (  # noqa: F401
    SegmentationDataset, AdvancedDataset, PatchDefectDataset,
    three_class_dataset, REMAP_7_TO_3, imread_rgb, imread_mask)
from unet_tpu_torch.data.loader import Loader, make_train_val_loaders  # noqa: F401
from unet_tpu_torch.data.augment import (  # noqa: F401
    AugmentationPipeline, StrongAugmentationPipeline, WeakAugmentationPipeline)
