"""PyTorch/CUDA port of DQRM for NVIDIA Hopper.

Sits beside `deep_quantized_recommendation_model_dqrm_tpu` (the JAX reference)
and imports nothing from it. Entry points run on the card (`device=None`
means "cuda") unless the caller passes `device="cpu"`; there the kernel
wrappers take their plain PyTorch versions.
"""
