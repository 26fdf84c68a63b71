from .geometry import (
    cam2pixel,
    euler2mat,
    inverse_warp,
    inverse_warp2,
    invert_pose_mat4,
    pixel2cam,
    pixel_grid,
    pose_mat4,
    pose_vec2mat,
    project_pixel_coords,
    quat2mat,
)
from .grid_sample import grid_sample
from .losses import mean_on_mask, photo_and_geometry_loss, smooth_loss
from .metrics import compute_depth_errors
from .ssim import ssim, ssim_nchw, ssim_nchw_bwd, ssim_nchw_plain
from .warp import warp_sample, warp_sample_bwd, warp_sample_plain
from . import cost_volume as _cost_volume  # the modules keep their names
from . import decoder_input as _decoder_input

# The wrappers that launch the hand-written kernels, each counting its
# launches in ``.launches``.
KERNEL_WRAPPERS = (warp_sample, warp_sample_bwd, ssim_nchw, ssim_nchw_bwd,
                   _decoder_input.decoder_input, _decoder_input.decoder_input_bwd,
                   _cost_volume.cost_volume)
