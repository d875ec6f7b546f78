"""The plain reference: the towers and the training step in float32.

Plain PyTorch on the benchmark's own weights (weights.py) and inputs; it
imports nothing of the program. It follows the published descriptions of
the configurations (OpenCLIP's ViT with a class token, timm's SigLIP ViT
with a MAP head, HuggingFace's XLM-RoBERTa with mean pooling and an MLP
head), with the departures its configuration file lists. TF32 is off while
it runs, so every product is a float32 one.

``linear="fp8"`` is the control: every linear layer's two operands rounded
to float8 e4m3 (per-tensor scale, amax at 448) before the float32 product,
the step that would tempt a faster program. Attention, LayerNorm and the
rest stay float32. Under autograd the rounding passes the gradient
straight through.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from h100bench.weights import leaf_norms

FP8_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """TF32 off for the products and convolutions inside."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class _RoundFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, grad):
        return grad


class Ref:
    """A configuration's towers over ``params`` ({name: tensor}, the port's
    keys), computed in float32."""

    def __init__(self, params: dict, shapes: dict, linear: str = "f32",
                 remat: bool = False):
        if linear not in ("f32", "fp8"):
            raise ValueError(f"unknown linear precision {linear!r}")
        self.p, self.shapes = params, shapes
        self.fp8, self.remat = linear == "fp8", remat

    def w(self, name):
        return self.p[name].float()

    def mm(self, x, w):
        if self.fp8:
            return _RoundFp8.apply(x) @ _RoundFp8.apply(w)
        return x @ w

    def dense(self, x, prefix):
        return self.mm(x, self.w(prefix + ".kernel")) + self.w(prefix + ".bias")

    def ln(self, x, prefix, eps):
        return F.layer_norm(x, (x.shape[-1],), self.w(prefix + ".scale"),
                            self.w(prefix + ".bias"), eps)

    @staticmethod
    def act(h, name):
        if name == "gelu":
            return F.gelu(h)
        if name == "gelu_tanh":
            return F.gelu(h, approximate="tanh")
        raise ValueError(f"unknown activation {name!r}")

    @staticmethod
    def attend(q, k, v, heads, key_bias=None):
        """Softmax attention of q (B, Q, D) over k, v (B, S, D), heads
        of D / heads; ``key_bias`` (B, S) added to the logits."""
        b, nq, d = q.shape
        hd = d // heads
        qh = q.reshape(b, nq, heads, hd).transpose(1, 2)
        kh = k.reshape(b, -1, heads, hd).transpose(1, 2)
        vh = v.reshape(b, -1, heads, hd).transpose(1, 2)
        logits = qh @ kh.transpose(-1, -2) / math.sqrt(hd)
        if key_bias is not None:
            logits = logits + key_bias[:, None, None, :]
        out = torch.softmax(logits, dim=-1) @ vh
        return out.transpose(1, 2).reshape(b, nq, d)

    # -- vision ------------------------------------------------------------
    def _vision_block(self, x, i):
        v = self.shapes["vision"]
        b = f"visual.transformer.resblocks.{i}."
        y = self.ln(x, b + "ln_1", v["ln_eps"])
        q, k, val = self.dense(y, b + "attn.in_proj").chunk(3, dim=-1)
        x = x + self.dense(self.attend(q, k, val, v["heads"]),
                           b + "attn.out_proj")
        y = self.ln(x, b + "ln_2", v["ln_eps"])
        h = self.act(self.dense(y, b + "mlp_fc"), v["act"])
        return x + self.dense(h, b + "mlp_proj")

    def encode_image(self, images, normalise: bool = True):
        """images (B, S, S, 3): uint8 frames (mean and std applied here) or,
        with ``normalise`` False, floats the tower takes as they are ->
        (B, embed_dim) unit rows."""
        v = self.shapes["vision"]
        x = images.float()
        if normalise:
            mean = torch.tensor(v["image_mean"], device=x.device)
            std = torch.tensor(v["image_std"], device=x.device)
            x = (x / 255.0 - mean) / std
        b, s, _, _ = x.shape
        p, d = v["patch_size"], v["width"]
        g = s // p
        x = x.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5)
        x = self.mm(x.reshape(b, g * g, p * p * 3),
                    self.w("visual.conv1.kernel").reshape(p * p * 3, d))
        cls = v["pool"] == "cls"
        if cls:
            c = self.w("visual.class_embedding").expand(b, 1, d)
            x = torch.cat([c, x], dim=1)
        else:
            x = x + self.w("visual.conv1.bias")
        x = x + self.w("visual.positional_embedding")
        if cls:
            x = self.ln(x, "visual.ln_pre", v["ln_eps"])
        for i in range(v["layers"]):
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(self._vision_block, x, i, use_reentrant=False)
            else:
                x = self._vision_block(x, i)
        if cls:
            out = self.ln(x[:, 0], "visual.ln_post", v["ln_eps"])
        else:
            out = self._map_head(self.ln(x, "visual.ln_post", v["ln_eps"]))
        if v.get("proj") != "identity":
            out = self.mm(out, self.w("visual.proj"))
        return F.normalize(out, dim=-1)

    def _map_head(self, x):
        v = self.shapes["vision"]
        a = "visual.attn_pool."
        b = x.shape[0]
        q = self.dense(self.w(a + "probe"), a + "q_proj").expand(b, 1, -1)
        k, val = self.dense(x, a + "kv_proj").chunk(2, dim=-1)
        out = self.dense(self.attend(q, k, val, v["heads"]), a + "out_proj")
        y = self.ln(out, a + "norm", v["ln_eps"])
        h = self.act(self.dense(y, a + "mlp_fc"), v["act"])
        return (out + self.dense(h, a + "mlp_proj"))[:, 0]

    # -- text (XLM-R) --------------------------------------------------------
    def encode_text(self, tokens):
        """tokens (B, L) int, ``pad_id`` at padding -> (B, embed_dim) unit
        rows: RoBERTa positions, post-LN layers under a key mask, mean
        pooling over real tokens, the bias-free GELU MLP head."""
        t = self.shapes["text"]
        eps, pad = t["ln_eps"], t["pad_id"]
        real = tokens != pad
        pos = real.long().cumsum(dim=1) * real + pad
        x = self.w("text.word_embeddings")[tokens]
        x = x + self.w("text.position_embeddings")[pos]
        x = self.ln(x, "text.emb_ln", eps)
        key_bias = torch.zeros(real.shape, device=x.device).masked_fill(
            ~real, -math.inf)
        for i in range(t["layers"]):
            b = f"text.layer_{i}."
            q, k, val = self.dense(x, b + "qkv").chunk(3, dim=-1)
            att = self.attend(q, k, val, t["heads"], key_bias)
            x = self.ln(x + self.dense(att, b + "attn_out"), b + "attn_ln",
                        eps)
            h = self.act(self.dense(x, b + "intermediate"), t["act"])
            x = self.ln(x + self.dense(h, b + "output"), b + "out_ln", eps)
        w = real[..., None].float()
        pooled = (x * w).sum(dim=1) / w.sum(dim=1).clamp(min=1)
        out = self.mm(F.gelu(self.mm(pooled, self.w("text.proj_fc"))),
                      self.w("text.proj_out"))
        return F.normalize(out, dim=-1)


def clip_loss(img, txt, scale):
    """Symmetric InfoNCE over the batch."""
    logits = scale * img @ txt.T
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (F.cross_entropy(logits, labels)
                  + F.cross_entropy(logits.T, labels))


@torch.no_grad()
def embed_frames(params, shapes, frames, block: int = 32,
                 linear: str = "f32"):
    """Unit image embeddings of uint8 frames (N, S, S, 3), ``block`` at a
    time, on the frames' device."""
    ref = Ref(params, shapes, linear)
    with exact_f32():
        return torch.cat([ref.encode_image(frames[i:i + block])
                          for i in range(0, len(frames), block)])


def train_steps(params, shapes, batches, lr: float, weight_decay: float,
                grad_clip: float, linear: str = "f32", rows=None):
    """Fine-tune ``params`` ({name: f32 leaf}, updated in place) one AdamW
    step a batch of ``batches`` [(images (B, S, S, 3) f32, tokens (B, L))]:
    the symmetric InfoNCE at exp(logit_scale), the global-norm clip (scale
    max_norm / norm only where the norm exceeds it), then AdamW (betas 0.9
    and 0.999, eps 1e-8 outside the root, decoupled decay on every leaf,
    a constant rate). ``rows`` (lo, hi) takes the loss over those rows of
    each batch alone (a planted fault). Returns (the losses before each
    step, {leaf: norm of the first step's clipped gradient}), leaves as
    ``weights.leaf_norms`` splits them)."""
    leaves = {n: t.requires_grad_(True) for n, t in params.items()}
    ref = Ref(leaves, shapes, linear, remat=True)
    m = {n: torch.zeros_like(t) for n, t in leaves.items()}
    v = {n: torch.zeros_like(t) for n, t in leaves.items()}
    losses, first = [], None
    b1, b2, eps = 0.9, 0.999, 1e-8
    with exact_f32():
        for step, (images, tokens) in enumerate(batches, start=1):
            if rows is not None:
                images, tokens = images[rows[0]:rows[1]], tokens[rows[0]:rows[1]]
            for t in leaves.values():
                t.grad = None
            loss = clip_loss(ref.encode_image(images, normalise=False),
                             ref.encode_text(tokens),
                             leaves["logit_scale"].exp())
            loss.backward()
            losses.append(float(loss.detach()))
            with torch.no_grad():
                grads = {n: t.grad for n, t in leaves.items()}
                norm = torch.linalg.vector_norm(torch.stack(
                    [torch.linalg.vector_norm(g) for g in grads.values()]))
                scale = (grad_clip / norm if grad_clip and norm >= grad_clip
                         else torch.ones_like(norm))
                if first is None:
                    first = leaf_norms(grads, scale)
                c1, c2 = 1 - b1 ** step, 1 - b2 ** step
                for n, t in leaves.items():
                    g = grads[n] * scale
                    t.mul_(1 - lr * weight_decay)
                    m[n].mul_(b1).add_(g, alpha=1 - b1)
                    v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (v[n] / c2).sqrt_().add_(eps)
                    t.addcdiv_(m[n], denom, value=-lr / c1)
    for t in leaves.values():
        t.grad = None
        t.requires_grad_(False)
    return losses, first
