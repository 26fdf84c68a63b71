from .state import TrainState, create_train_state, make_optimizer
from .step import (
    LossConfig,
    compute_depth,
    compute_pose_with_inv,
    make_eval_depth_step,
    make_eval_step,
    make_inference_fn,
    make_train_step,
    total_loss,
)
from .checkpoint import restore_train_state, save_checkpoint
