"""Policy-MLP acting forward op: the CUDA kernel ``csrc/mlp.cu`` and its plain
version.

Port of marlpde_tpu/ops/mlp_pallas.py.  ``mlp_forward(obs, net)`` returns
``net(obs)`` for a two-hidden-layer ``VracerNet``: on CPU tensors by calling
the module (the plain version), on CUDA tensors by launching the kernel, or
raising.  The tensor's device alone picks between them.  The kernel computes
the full acting forward, including the sigma cap's forward value and the
``sigma_relative`` mean; the losses differentiate the module itself, so the
op needs no backward.

The kernel has two routes, chosen by the obs width alone (``wide_route``).
The narrow one (obs <= 4) runs layer 2 on the tensor cores in 3xTF32 and
layer 1 and the heads in float32; the wide one runs all three products in
3xTF32, with the heads as one product of h2 with ``head_matrix``.
``split_tf32`` is the split both use, and ``mlp_forward_tf32`` a plain
emulation of their arithmetic (the CPU tests hold both against the JAX
package).  The narrow route reads W2 as ``w2_image``, kept on the module in
one buffer that is rewritten in place, never replaced, so a captured CUDA
graph that reads it stays valid.  Two things rewrite it: ``refresh_w2_image``,
which every VRACER update calls after its optimizer step (a replayed update
changes W2 without bumping its version counter, and rewrites the image inside
the same graph), and the wrapper itself when W2's storage or version counter
has changed since the last write (an eager in-place edit: ``load_state_dict``,
a test's perturbation).  The wide route splits every weight in the kernel as
it stages it, so it reads the parameters themselves and needs no image.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from marlpde_tpu_torch.kernels import build
from marlpde_tpu_torch.utils import profiling

# kernel launches since the last reset; incremented only where the CUDA kernel
# is launched (the tracer also counts them by shape: launches/<kernel> <shape>)
launches = 0
# writes of a W2 image for the kernel since the last reset, by the host
# (a replayed update's rewrite is not counted); not kernel launches
w2_splits = 0

MAX_WIDTH = 256     # csrc/mlp.cu kMaxWidth: the widest wgmma (m64n256)
CHUNK_K = 32        # csrc/mlp.cu kChunkK: input units of one W2 chunk
SMALL_OBS = 4       # csrc/mlp.cu kSmallD: the obs widths of the narrow route
HEAD_N = 64         # csrc/mlp.cu kHeadN: head columns of one wide-route tile
ROUTES = {None: 0, "narrow": 1, "wide": 2}   # csrc/mlp.cu mlp_forward's route


def wide_route(obs_dim: int) -> bool:
    """Whether the kernel takes obs rows this wide by its wide route (layer 1
    and the heads on the tensor cores) rather than its narrow one."""
    return obs_dim > SMALL_OBS


def split_tf32(w):
    """float32 ``w`` -> (hi, lo) with hi = w rounded to TF32 (10 mantissa bits,
    to nearest, ties away from zero, as ``cvt.rna.tf32.f32``) and lo = w - hi,
    so hi + lo == w exactly.  Where rounding would overflow to infinity, hi is
    w truncated instead; infinities and NaNs give (w, 0)."""
    if w.dtype != torch.float32:
        raise TypeError(f"split_tf32: takes float32, got {w.dtype}")
    bits = w.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    truncated = (bits & -0x2000).view(torch.float32)
    finite = torch.isfinite(w)
    hi = torch.where(finite, torch.where(torch.isfinite(rounded), rounded, truncated), w)
    lo = torch.where(finite, w - hi, torch.zeros_like(w))
    return hi, lo


def _tf32_truncate(x):
    """What the tensor cores read of a float32 operand: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _tf32_product(a, w, products, wide=False):
    """a @ w.T from TF32 operands with exact products and float32 sums: 3xTF32
    (lo*hi + hi*lo + hi*hi) or, with ``products`` = 1, plain TF32.  Each
    operand x is split as hi = x rounded to TF32 and lo = x - hi, which the
    tensor cores truncate to TF32; the wide route instead rounds a's lo to
    TF32 and takes w's hi as its truncation (the kernel stages w raw) and
    w's lo as the rest rounded to TF32."""
    a_hi, a_lo = split_tf32(a)
    if wide:
        a_lo = split_tf32(a_lo)[0]
        b_hi = _tf32_truncate(w)
        b_lo = split_tf32(w - b_hi)[0]
    else:
        b_hi, b_lo = split_tf32(w)
    acc = a_hi @ b_hi.T
    if products == 3:
        acc = _tf32_truncate(a_lo) @ b_hi.T + a_hi @ _tf32_truncate(b_lo).T + acc
    return acc


def head_matrix(net):
    """The heads as the wide route's product reads them: (tiles * HEAD_N, W)
    weights and (tiles * HEAD_N,) biases.  Tile ct's first HEAD_N / 2 rows are
    the mu rows of action slots ct * HEAD_N / 2 onwards, its last HEAD_N / 2
    their sigma rows; slot A is the value head (with a zero sigma row), the
    slots past it are zero."""
    W, A = net.width, net.act_dim
    slots = HEAD_N // 2
    tiles = -(-(A + 1) // slots)
    like = net.mu.weight
    weight = like.new_zeros(tiles * slots, 2, W)
    bias = like.new_zeros(tiles * slots, 2)
    weight[:A, 0] = net.mu.weight
    weight[:A, 1] = net.sigma.weight
    weight[A, 0] = net.value.weight[0]
    bias[:A, 0] = net.mu.bias
    bias[:A, 1] = net.sigma.bias
    bias[A, 0] = net.value.bias[0]
    weight = weight.view(tiles, slots, 2, W).transpose(1, 2).reshape(tiles * HEAD_N, W)
    return weight, bias.view(tiles, slots, 2).transpose(1, 2).reshape(-1)


def mlp_forward_tf32(obs, net, products: int = 3, wide_products: int | None = None):
    """Plain emulation of the kernel's arithmetic, by the kernel's route.
    Layer 2 from TF32 operands with exact products and float32 sums, as
    ``products`` = 3 (3xTF32: lo*hi + hi*lo + hi*hi) or 1 (plain TF32).  On
    the narrow route layer 1 and the heads are float32; on the wide route they
    are TF32 products too, as ``wide_products`` (``products`` if None), the
    heads as one product with ``head_matrix``, with the wide route's split
    (``_tf32_product``).  The sums here round to nearest in any order; the
    kernel's round each 32-input chunk's toward zero, in the tensor cores,
    and the rest to nearest."""
    wide_products = products if wide_products is None else wide_products
    if products not in (1, 3) or wide_products not in (1, 3):
        raise ValueError(f"mlp_forward_tf32: products must be 1 or 3, got "
                         f"{products}, {wide_products}")
    lin1, lin2 = net.hidden
    wide = wide_route(net.obs_dim)
    if wide:
        h1 = torch.tanh(_tf32_product(obs, lin1.weight, wide_products, True) + lin1.bias)
    else:
        h1 = torch.tanh(lin1(obs))
    h2 = torch.tanh(_tf32_product(h1, lin2.weight, products, wide) + lin2.bias)
    if not wide:
        return net.heads(h2)
    weight, bias = head_matrix(net)
    A, slots = net.act_dim, HEAD_N // 2
    out = (_tf32_product(h2, weight, wide_products, True) + bias).view(len(obs), -1, 2, slots)
    m, raw = out[:, :, 0].flatten(1), out[:, :, 1].flatten(1)
    sigma = torch.logaddexp(raw[:, :A], torch.zeros_like(raw[:, :A])) * net.sigma_scale \
        + net.sigma_floor
    sigma = torch.minimum(sigma, torch.full_like(sigma, net.sigma_max))
    mu = m[:, :A] * sigma if net.mu_param == "sigma_relative" else m[:, :A]
    return m[:, A], mu, sigma


def w2_image(w2):
    """W2 (W, W) in nn.Linear's layout -> the kernel's image of it, (W/32, 2,
    W, 32) float32: chunk kc, then hi and lo of ``split_tf32``, then row n of
    input units 32 kc .. 32 kc + 31, whose 16-byte group j (4 units) sits at
    j ^ (n % 8): the 128-byte swizzle of a K-major wgmma operand."""
    W = w2.shape[0]
    hi, lo = split_tf32(w2)
    parts = torch.stack([hi, lo]).view(2, W, W // CHUNK_K, 8, 4).permute(2, 0, 1, 3, 4)
    n = torch.arange(W, device=w2.device)
    group = torch.arange(8, device=w2.device)[None, :] ^ (n[:, None] % 8)   # (n, slot) -> j
    img = torch.gather(parts, 3, group[None, None, :, :, None].expand(parts.shape))
    return img.reshape(W // CHUNK_K, 2, W, CHUNK_K)


def _w2_key(w2):
    return (w2.data_ptr(), w2._version, w2.device)


@torch.no_grad()
def _write_w2_image(net):
    """Write ``w2_image`` of the net's W2 into the net's image buffer (made on
    first use), and note W2's storage and version."""
    global w2_splits
    w2 = net.hidden[1].weight
    cached = getattr(net, "_mlp_w2_image", None)
    if cached is None or cached[1].device != w2.device:
        cached = [None, w2_image(w2.detach())]
        net._mlp_w2_image = cached
    else:
        cached[1].copy_(w2_image(w2.detach()))
    cached[0] = _w2_key(w2)
    w2_splits += 1
    return cached[1]


def kernel_takes(net) -> bool:
    """Whether the CUDA kernel takes the net's shape: two hidden layers of a
    width that is a multiple of 32 up to MAX_WIDTH."""
    W = net.width
    return net.n_hidden == 2 and W % CHUNK_K == 0 and 32 <= W <= MAX_WIDTH


def refresh_w2_image(net):
    """Rewrite the net's W2 image from W2: what an optimizer step calls, so
    that the next acting forward reads the new W2 whether or not the step
    bumped W2's version counter.  On the card the image is made here if the
    kernel takes the net by its narrow route (a graphed update captures the
    rewrite only if the buffer exists when it is captured); on the CPU, and
    for a net of the wide route, only an image that exists is rewritten."""
    if getattr(net, "_mlp_w2_image", None) is not None or (
            kernel_takes(net) and not wide_route(net.obs_dim) and net.hidden[1].weight.is_cuda):
        _write_w2_image(net)


def _cached_w2_image(net):
    """The net's W2 image buffer, rewritten first when W2's storage or version
    changed since the last write."""
    cached = getattr(net, "_mlp_w2_image", None)
    if cached is None or cached[0] != _w2_key(net.hidden[1].weight):
        return _write_w2_image(net)
    return cached[1]


@lru_cache(maxsize=None)
def _library():
    lib = build.load("mlp")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mlp_forward.argtypes = [ptr] * 15 + [i32] * 4 + [f32] * 3 + [i32, i32, ptr]
    lib.mlp_forward.restype = ctypes.c_int
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def mlp_forward(obs, net, route: str | None = None):
    """obs (R, obs_dim) -> (V (R,), mu (R, A), sigma (R, A)) of ``net``.
    ``route`` forces the kernel's route ("narrow", for obs widths up to
    SMALL_OBS, or "wide"); None takes ``wide_route``'s."""
    global launches
    if obs.ndim != 2 or obs.shape[1] != net.obs_dim:
        raise ValueError(f"mlp_forward: obs must be (R, {net.obs_dim}), got {tuple(obs.shape)}")
    if route not in ROUTES or (route == "narrow" and wide_route(net.obs_dim)):
        raise ValueError(f"mlp_forward: route {route!r} for obs width {net.obs_dim}")
    params = [t for lin in net.layers() for t in (lin.weight, lin.bias)]
    for t in params:
        if t.device != obs.device or t.dtype != obs.dtype:
            raise ValueError(f"mlp_forward: parameter {t.dtype} on {t.device} does not "
                             f"match obs {obs.dtype} on {obs.device}")
    if obs.device.type == "cpu":
        return net(obs)
    if obs.device.type != "cuda":
        raise ValueError(f"mlp_forward: no kernel for device {obs.device}")
    if obs.dtype != torch.float32:
        raise TypeError(f"mlp_forward: the CUDA kernel takes float32, got {obs.dtype}")
    R, D = obs.shape
    W, A = net.width, net.act_dim
    if not kernel_takes(net) or R == 0:
        raise ValueError(f"mlp_forward: the CUDA kernel takes n_hidden=2, a width that "
                         f"is a multiple of 32 up to {MAX_WIDTH}, and R >= 1; got "
                         f"n_hidden={net.n_hidden}, width={W}, R={R}")
    if not obs.is_contiguous() or not all(t.is_contiguous() for t in params):
        raise ValueError("mlp_forward: obs and parameters must be contiguous")
    if any(t.data_ptr() % 8 for t in params):
        raise ValueError("mlp_forward: parameters must be 8-byte aligned (float2 loads)")
    lib = _library()
    narrow = route == "narrow" or (route is None and not wide_route(D))
    # the narrow route reads W2 as its image, the wide one W2 itself
    w2img = _cached_w2_image(net).data_ptr() if narrow else 0
    ptrs = [t.data_ptr() for t in params]
    V = torch.empty(R, dtype=obs.dtype, device=obs.device)
    mu = torch.empty(R, A, dtype=obs.dtype, device=obs.device)
    sigma = torch.empty(R, A, dtype=obs.dtype, device=obs.device)
    with torch.cuda.device(obs.device):
        status = lib.mlp_forward(
            obs.data_ptr(), *ptrs[:2], w2img, *ptrs[2:],
            V.data_ptr(), mu.data_ptr(), sigma.data_ptr(), R, D, W, A,
            net.sigma_scale, net.sigma_floor, float(net.sigma_max),
            int(net.mu_param == "sigma_relative"), ROUTES[route],
            torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError(f"mlp_forward: launch failed: "
                           f"{lib.error_string(status).decode()} ({status})")
    launches += 1
    profiling.count(f"launches/mlp {R}x{D}x{W}x{A}")
    return V, mu, sigma
