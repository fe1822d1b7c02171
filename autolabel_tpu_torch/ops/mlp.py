"""Small bias-free ReLU MLPs for the field heads.

Counterpart of autolabel_tpu/ops/mlp.py. Weights are (in, out) matrices,
the JAX layout. Products take their operands in the compute dtype and
accumulate in fp32: bf16 on the card (the TPU's MXU rule), fp32 on the
CPU (the JAX package's CPU rule, so CPU parity is fp32-tight).
"""
import torch


def mlp_init(generator, in_dim, hidden_dim, out_dim, n_hidden,
             dtype=torch.float32):
    """He-uniform init of [in->h, h->h (x n_hidden-1), h->out] weights.

    n_hidden counts hidden layers (tcnn's n_hidden_layers): the network has
    n_hidden + 1 weight matrices. Draws on the CPU from `generator`.
    """
    dims = [in_dim] + [hidden_dim] * n_hidden + [out_dim]
    weights = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        bound = (6.0 / d_in) ** 0.5
        w = torch.rand((d_in, d_out), generator=generator, dtype=dtype)
        weights.append(w * (2.0 * bound) - bound)
    return weights


def default_compute_dtype(device):
    """bf16 on the card, fp32 elsewhere (ops/mlp._default_compute_dtype)."""
    return torch.bfloat16 if torch.device(device).type == 'cuda' \
        else torch.float32


def dot(a, b, compute_dtype):
    """a @ b with operands rounded to compute_dtype and fp32 accumulation.

    The operands are rounded and then multiplied in fp32, which is what
    `jnp.dot(..., preferred_element_type=float32)` computes: products of
    bf16 values are exact in fp32. (A native bf16 torch.matmul would round
    its output to bf16 as well.) fp32 products on the card need
    torch.backends.cuda.matmul.allow_tf32 False, PyTorch's default.
    """
    if compute_dtype != torch.float32:
        a = a.to(compute_dtype)
        b = b.to(compute_dtype)
    return torch.matmul(a.float(), b.float())


def mlp_apply(weights, x, compute_dtype=None):
    """ReLU MLP forward; see autolabel_tpu/ops/mlp.mlp_apply.

    x may be a list/tuple of feature segments: the first layer is then a
    sum of partial products over row slices of weights[0]. Segments
    narrower than 32 stay fp32, as in the JAX package.
    """
    if compute_dtype is None:
        first = x[0] if isinstance(x, (list, tuple)) else x
        compute_dtype = default_compute_dtype(first.device)
    if isinstance(x, (list, tuple)):
        w0 = weights[0]
        h = None
        offset = 0
        for segment in x:
            width = segment.shape[-1]
            seg_dtype = compute_dtype if width >= 32 else torch.float32
            part = dot(segment, w0[offset:offset + width], seg_dtype)
            h = part if h is None else h + part
            offset += width
        if offset != w0.shape[0]:
            raise ValueError(
                f"segments cover {offset} of {w0.shape[0]} input dims")
        if len(weights) == 1:
            return h
        h = torch.relu(h)
        weights = weights[1:]
    else:
        h = x
    for i, w in enumerate(weights):
        h = dot(h, w, compute_dtype)
        if i + 1 < len(weights):
            h = torch.relu(h)
    return h
