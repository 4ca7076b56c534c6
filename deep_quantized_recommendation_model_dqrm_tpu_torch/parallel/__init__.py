from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel.mesh import (  # noqa: F401
    get_my_slice,
    get_split_lengths,
    table_assignment,
)
