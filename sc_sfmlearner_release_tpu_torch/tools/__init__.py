"""Tools of the PyTorch/CUDA port, each ``python -m
sc_sfmlearner_release_tpu_torch.tools.<name>``: the counterparts of the
repository's ``tools/`` that the port has (``convert_checkpoint``,
``synthetic_scene``, ``overfit_check``, ``mfu_report``, ``profile_step``,
``ablate_step``, ``make_smoke_kitti``, ``make_smoke_nyu``) and
``ssim_variants``."""
