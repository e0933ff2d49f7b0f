from .attention import layout_equations, write_row_pe
from .linear_attention import (
    causal_linear_attention,
    causal_linear_attention_ref,
    draw_orthogonal_features,
    favor_causal_attention,
    favor_features,
    linear_attention_decode_step,
)
from .performer_decode import fused_decode_layer
from .sampling import nucleus_sample, nucleus_sample_numpy
