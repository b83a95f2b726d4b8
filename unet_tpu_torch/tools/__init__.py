"""Dataset, calibration and evaluation tools of the port (counterpart of
unet_tpu/tools/, the reference tools/ zoo), behind `cli tools`. Every tool
of the JAX package is here; OpenCV (`cv2`) is imported inside the functions
that use it. Of the JAX package's CLI only `bench` (ROADMAP A5) is left, and
of the device mesh the spatial train step (ROADMAP A15d) and the model zoo
on stripes (A15e)."""
from unet_tpu_torch.tools.frames_extract import extract_frames, ahash, hash_similarity  # noqa: F401
from unet_tpu_torch.tools.dataset_audit import (  # noqa: F401
    audit_labelme_dir, diagnose_mask, class_pixel_distribution, remap_masks,
    update_dataset, rectangles_to_labelme)
from unet_tpu_torch.tools.calibrate import (  # noqa: F401
    scale_from_two_points, save_roi_json, load_roi_json, propose_roi_from_video)
from unet_tpu_torch.tools.evaluate import (  # noqa: F401
    evaluate_dataset, SingleImageInference, summarize_checkpoints)
from unet_tpu_torch.tools.hard_negatives import create_hard_negative_dataset  # noqa: F401
from unet_tpu_torch.tools.visualize_dataset import render_masks, render_predictions  # noqa: F401
from unet_tpu_torch.tools.annotate import (  # noqa: F401
    load_annotations, save_annotations, add_boxes, annotations_to_labelme)
