"""mst_tpu_torch: the PyTorch + CUDA port of mst_tpu for an NVIDIA H100.

The serving slice of the flagship MST-DINOv2 classifier: the fused ViT
sub-layers run on hand-written Hopper kernels (`csrc/`), the rest is plain
PyTorch. Imports torch, numpy and the standard library only; the JAX
package `mst_tpu` is the reference it is tested against.

    from mst_tpu_torch.registry import get_model
    from mst_tpu_torch.models.convert import params_from_flax, random_flax_params
    from mst_tpu_torch.train.predictor import make_predict_fn
"""

__version__ = "0.1"
