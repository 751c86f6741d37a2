"""The yardstick's arithmetic for the DeepSeek-V3-type policy (the Moonlight
configuration), frozen with the benchmark: the operations and bytes of its
forward and of its routed experts' grouped GEMMs, counted from a
configuration's sizes, and the least time they need on the card
(``frozen.bound``'s peaks).

Operations are the model's multiply-adds times two, the padding and the
duplicated work a kernel may do left out: per row and layer q (E x H(nope +
rope)), the latent and shared rope key (E x (R + rope)), keys and values (R
x H(nope + v)), scores (T x H(nope + rope)) and P V (T x H v), the output
projection (H v x E); then a dense SwiGLU (3 E F) or the router (E X), the
k routed experts (3 E f each) and the shared ones (3 E S f).  The last layer
is thinned: its latent and keys and values at every position, the rest at
the last position alone; the head (E x V) at the last position.
"""

from __future__ import annotations

from perfbench.frozen import HBM_BYTES_PER_S, PEAK_BF16, bound


def _sizes(cfg: dict):
    return (cfg["hidden_size"], cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
            cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"])


def _attention_row(cfg: dict, t: int) -> tuple[int, int, int]:
    """(q and output projection, latent and keys|values, attention core) FLOP
    of one query row."""
    e, h, dn, dr, dv, r = _sizes(cfg)
    proj = 2 * e * h * (dn + dr) + 2 * h * dv * e
    latent = 2 * e * (r + dr) + 2 * r * h * (dn + dv)
    core = 2 * t * h * (dn + dr) + 2 * t * h * dv
    return proj, latent, core


def mlp_row(cfg: dict, i: int) -> int:
    """FLOP of layer i's MLP on one row."""
    e = cfg["hidden_size"]
    if i < cfg["first_k_dense_replace"]:
        return 2 * 3 * e * cfg["intermediate_size"]
    f = cfg["moe_intermediate_size"]
    return (2 * e * cfg["n_routed_experts"] + 2 * cfg["num_experts_per_tok"] * 3 * e * f
            + 2 * 3 * e * cfg["n_shared_experts"] * f)


def forward_flops(cfg: dict) -> int:
    """The products one context's forward needs, the last layer thinned and
    the head at the last position."""
    t, layers = cfg["block_size"], cfg["num_hidden_layers"]
    proj, latent, core = _attention_row(cfg, t)
    total = sum(t * (proj + latent + core + mlp_row(cfg, i)) for i in range(layers - 1))
    total += t * latent + proj + core + mlp_row(cfg, layers - 1)
    return total + 2 * cfg["hidden_size"] * cfg["vocab_size"]


def weight_bytes(cfg: dict) -> int:
    """The weights as the program holds them: bf16, the norm gains, the
    router's weight and bias in fp32."""
    from perfbench.moe_weights import layer_shapes

    total = 2 * 2 * cfg["vocab_size"] * cfg["hidden_size"] + 4 * cfg["hidden_size"]
    for i in range(cfg["num_hidden_layers"]):
        for key, shape in layer_shapes(cfg, i):
            n = 1
            for s in shape:
                n *= s
            fp32 = len(shape) == 1 or key == "mlp.gate.weight"
            total += (4 if fp32 else 2) * n
    return total


def forward_bound(cfg: dict, n: int) -> tuple[float, str]:
    """Least time (ms) of the forward on n contexts: its products at the bf16
    rate, against the weights read once, the tokens in and the logits out."""
    io = n * cfg["block_size"] * 4 + n * cfg["vocab_size"] * 4
    return bound(n * forward_flops(cfg), 0, weight_bytes(cfg) + io)


def routed_rows(cfg: dict, n: int) -> list[int]:
    """Token rows of each MoE layer in a forward on n contexts (the last
    layer thinned)."""
    t, layers = cfg["block_size"], cfg["num_hidden_layers"]
    return [n * t if i < layers - 1 else n
            for i in range(cfg["first_k_dense_replace"], layers)]


def experts_flops(cfg: dict, n: int) -> int:
    """The routed experts' products in a forward on n contexts: k rows a
    token, gate, up and down of E x f each."""
    k, e, f = cfg["num_experts_per_tok"], cfg["hidden_size"], cfg["moe_intermediate_size"]
    return sum(rows * 2 * k * 3 * e * f for rows in routed_rows(cfg, n))


def experts_bound(cfg: dict, n: int) -> tuple[float, str]:
    """Least time (ms) of the routed experts' grouped GEMMs in a forward on n
    contexts: their products, against each MoE layer's expert weights read
    once, the permuted rows read, the hidden rows written and read, and the
    outputs written."""
    k, e, f, x = (cfg["num_experts_per_tok"], cfg["hidden_size"],
                  cfg["moe_intermediate_size"], cfg["n_routed_experts"])
    nbytes = sum(2 * (k * rows * e + x * 3 * e * f + 2 * k * rows * f + k * rows * e)
                 for rows in routed_rows(cfg, n))
    return bound(experts_flops(cfg, n), 0, nbytes)


__all__ = ["HBM_BYTES_PER_S", "PEAK_BF16", "experts_bound", "experts_flops", "forward_bound",
           "forward_flops", "mlp_row", "routed_rows", "weight_bytes"]
