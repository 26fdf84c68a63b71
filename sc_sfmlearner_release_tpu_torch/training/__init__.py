from .step import (
    LossConfig,
    compute_depth,
    compute_pose_with_inv,
    make_eval_step,
    make_inference_fn,
    total_loss,
)
