"""Image/mask ops of the port, one module per counterpart in unet_tpu.ops.

  color       bgr2rgb / rgb2gray / bgr2gray
  image       resize_bilinear / resize_nearest / gaussian_blur
  morph       ellipse_kernel / dilate / erode / open_ / close_ / outer_band
  edges       canny / hysteresis
  cc          filter_components_by_geometry, connected_components,
              component_stats, keep_mask, largest_component, count_components
  geometry    width_per_row, diameter_metrics, analyze_defects and the rest
              of the diameter and defect geometry
  cc_kernels  propagate: the CUDA kernel for the CC/hysteresis fixpoint
  nlm_kernels nlm: the CUDA kernel for non-local-means denoising
  qconv_kernels qconv: the CUDA int8 3x3 conv with its requant fused
  seg_metrics confusion_matrix / metrics_from_confusion / compute_metrics
"""
