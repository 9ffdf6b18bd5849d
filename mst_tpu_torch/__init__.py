"""mst_tpu_torch: the PyTorch + CUDA port of mst_tpu for an NVIDIA H100.

Serving and training of the MST-DINOv2 and MST-DINOv3 classifiers: the fused ViT
sub-layers and their backward run on hand-written Hopper kernels (`csrc/`),
the rest is plain PyTorch. Imports torch, numpy and the standard library
only; the JAX package `mst_tpu` is the reference it is tested against.

    from mst_tpu_torch.registry import get_model
    from mst_tpu_torch.models.convert import params_from_flax, random_flax_params
    from mst_tpu_torch.train.predictor import make_predict_fn
    from mst_tpu_torch.train.trainer import Trainer, make_train_step

    python -m mst_tpu_torch.train --dataset Synthetic   # train on the card
    python -m mst_tpu_torch.serve --params_npz PATH     # serve the result
"""

__version__ = "0.1"
