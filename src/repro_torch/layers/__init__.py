"""Model layers: norms, RoPE, attention (plain versions), MLP."""
from repro_torch.layers.attention import NEG_INF, decode_mha, mha_einsum
from repro_torch.layers.mlp import mlp_apply, mlp_init
from repro_torch.layers.norms import rms_norm
from repro_torch.layers.rope import apply_mrope, apply_rope, make_positions

__all__ = ["NEG_INF", "decode_mha", "mha_einsum", "mlp_apply", "mlp_init",
           "rms_norm", "apply_mrope", "apply_rope", "make_positions"]
