"""The "official" TF1 Inception IS/FID, executed in PyTorch without
TensorFlow: port of ``ic_gan_tpu/eval/tf_inception.py``.

The reference's canonical numbers come from the frozen 2015 Inception
classifier run under TF1 (``data_utils/inception_tf13.py``): images in
[0, 255] are fed to ``ExpandDims:0``, ``pool_3:0`` (2048-d) feeds the FID
moments, and IS uses ``softmax(matmul(squeeze(pool_3), W))`` with ``W`` the
graph's ``softmax/logits/MatMul`` weights (``inception_tf13.py:162-186``).

``io/graphdef.py`` decodes ``classify_image_graph_def.pb`` (env-gated:
``$ICGAN_TF_INCEPTION_PB``; nothing is downloaded), and ``TFGraphExecutor``
interprets the ops frozen classifier graphs use (Conv2D,
BatchNormWithGlobalNormalization, pooling, concat, TF1's legacy
ResizeBilinear grid) with torch ops on a device, NHWC as TF lays tensors
out, in full float32 (no TF32).  IS and FID then follow the reference's
split-KL and moment formulas (``inception_tf13.py:120-160,269-272``).
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ic_gan_tpu_torch import resolve_device
from ic_gan_tpu_torch.eval.fid import full_f32
from ic_gan_tpu_torch.io.graphdef import DTYPES, NodeDef, parse_graphdef


def _legacy_axis_matrix(n_in: int, n_out: int, align_corners: bool) -> np.ndarray:
    scale = (n_in - 1) / (n_out - 1) if align_corners and n_out > 1 else n_in / n_out
    src = np.arange(n_out, dtype=np.float64) * scale
    i0 = np.clip(np.floor(src).astype(np.int64), 0, n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    frac = (src - i0).astype(np.float32)
    m = np.zeros((n_out, n_in), np.float32)
    m[np.arange(n_out), i0] += 1 - frac
    m[np.arange(n_out), i1] += frac
    return m


def _resize_bilinear_tf_legacy(x: torch.Tensor, out_h: int, out_w: int,
                               align_corners: bool = False) -> torch.Tensor:
    """TF1 ``ResizeBilinear`` (half_pixel_centers=False) of NHWC ``x``:
    src = dst · in/out, the legacy grid, not the half-pixel one;
    ``align_corners`` uses (in − 1)/(out − 1).  Two dense interpolation
    products."""
    mh = torch.from_numpy(_legacy_axis_matrix(x.shape[1], out_h, align_corners)).to(x)
    mw = torch.from_numpy(_legacy_axis_matrix(x.shape[2], out_w, align_corners)).to(x)
    x = torch.einsum("oh,nhwc->nowc", mh, x)
    return torch.einsum("ow,nhwc->nhoc", mw, x)


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """TF's SAME padding of one axis: (before, after), the odd one after."""
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pads(x_nchw: torch.Tensor, window, strides, padding: str) -> Tuple[int, int, int, int]:
    """``F.pad`` widths (left, right, top, bottom) of an NCHW tensor."""
    if padding == "VALID":
        return (0, 0, 0, 0)
    top, bottom = _same_pads(x_nchw.shape[2], window[0], strides[0])
    left, right = _same_pads(x_nchw.shape[3], window[1], strides[1])
    return (left, right, top, bottom)


def _pool(x: torch.Tensor, ksize, strides, padding: str, kind: str) -> torch.Tensor:
    """NHWC max or average pooling with TF's window, strides and padding;
    TF's SAME average divides by the in-bounds count."""
    window, step = tuple(ksize[1:3]), tuple(strides[1:3])
    if tuple(ksize[::3]) != (1, 1) or tuple(strides[::3]) != (1, 1):
        raise NotImplementedError("pooling over the batch or channel axis")
    x = x.permute(0, 3, 1, 2)
    pads = _pads(x, window, step, padding)
    if kind == "max":
        out = F.max_pool2d(F.pad(x, pads, value=-math.inf), window, step)
    else:
        out = F.avg_pool2d(F.pad(x, pads), window, step, divisor_override=1)
        if padding != "VALID":
            ones = F.pad(torch.ones_like(x[:1, :1]), pads)
            out = out / F.avg_pool2d(ones, window, step, divisor_override=1)
        else:
            out = out / float(np.prod(window))
    return out.permute(0, 2, 3, 1)


def _conv2d(x: torch.Tensor, w: torch.Tensor, strides, padding: str) -> torch.Tensor:
    """NHWC input, HWIO kernel, TF strides and padding → NHWC."""
    x = x.permute(0, 3, 1, 2)
    w = w.permute(3, 2, 0, 1)
    step = tuple(strides[1:3])
    x = F.pad(x, _pads(x, w.shape[2:], step, padding))
    return F.conv2d(x, w, stride=step).permute(0, 2, 3, 1)


class TFGraphExecutor:
    """Interpret a frozen TF GraphDef with torch ops on ``device`` (CUDA
    unless named), NHWC.

    ``feed`` names a node whose output the caller supplies (the reference
    feeds ``ExpandDims:0``); everything upstream of it is cut.  ``fetches``
    are the node names returned.  Constants move to the device once, at
    their first use."""

    SUPPORTED = {
        "Const", "Identity", "Placeholder", "ExpandDims", "Cast",
        "ResizeBilinear", "Sub", "Mul", "Add", "Conv2D",
        "BatchNormWithGlobalNormalization", "Relu", "MaxPool", "AvgPool",
        "Concat", "ConcatV2", "Reshape", "MatMul", "BiasAdd", "Softmax",
        "Squeeze",
    }

    def __init__(self, nodes: Sequence[NodeDef], feed: str, fetches: Sequence[str],
                 device=None):
        self.device = resolve_device(device)
        self.nodes: Dict[str, NodeDef] = {n.name: n for n in nodes}
        self.feed = feed
        self.fetches = list(fetches)
        self._consts: Dict[str, np.ndarray] = {
            n.name: np.asarray(n.attrs["value"].tensor) for n in nodes if n.op == "Const"}
        self._on_device: Dict[str, torch.Tensor] = {}

    def const(self, name: str) -> np.ndarray:
        """A Const node's tensor (e.g. the softmax MatMul weights)."""
        return self._consts[name.split(":")[0]]

    def _const_int(self, inp: str) -> np.ndarray:
        return np.asarray(self._consts[inp.split(":")[0]]).astype(np.int64)

    def __call__(self, fed_value: torch.Tensor) -> List[torch.Tensor]:
        cache: Dict[str, torch.Tensor] = {self.feed: fed_value}

        def ref(inp: str) -> torch.Tensor:
            # "name", "name:0", "^name" (control dependencies are ignored)
            return evaluate(inp.lstrip("^").split(":")[0])

        def evaluate(name: str) -> torch.Tensor:
            if name not in cache:
                cache[name] = self._run_node(self.nodes[name], ref)
            return cache[name]

        return [evaluate(f.split(":")[0]) for f in self.fetches]

    def _run_node(self, node: NodeDef, ref) -> torch.Tensor:
        op, a = node.op, node.attrs
        ins = [i for i in node.inputs if not i.startswith("^")]
        if op == "Const":
            if node.name not in self._on_device:
                self._on_device[node.name] = torch.from_numpy(
                    np.array(self._consts[node.name])).to(self.device)
            return self._on_device[node.name]
        if op in ("Identity", "CheckNumerics"):
            return ref(ins[0])
        if op == "ExpandDims":
            return ref(ins[0]).unsqueeze(int(self._const_int(ins[1])))
        if op == "Cast":
            return ref(ins[0]).to(_torch_dtype(a.get("DstT")))
        if op == "ResizeBilinear":
            size = self._const_int(ins[1])
            ac = bool(a["align_corners"].b) if "align_corners" in a else False
            return _resize_bilinear_tf_legacy(ref(ins[0]), int(size[0]), int(size[1]), ac)
        if op in ("Sub", "Mul", "Add"):
            x, y = ref(ins[0]), ref(ins[1])
            return {"Sub": torch.sub, "Mul": torch.mul, "Add": torch.add}[op](x, y)
        if op == "Conv2D":
            strides = list(a["strides"].list_i) or [1, 1, 1, 1]
            return _conv2d(ref(ins[0]), ref(ins[1]), strides, a["padding"].s.decode())
        if op == "BatchNormWithGlobalNormalization":
            x, m, v, beta, gamma = (ref(i) for i in ins[:5])
            inv = torch.rsqrt(v + float(a["variance_epsilon"].f))
            if bool(a["scale_after_normalization"].b) if "scale_after_normalization" in a \
                    else True:
                inv = inv * gamma
            return x * inv + (beta - m * inv)
        if op == "Relu":
            return F.relu(ref(ins[0]))
        if op in ("MaxPool", "AvgPool"):
            return _pool(ref(ins[0]), list(a["ksize"].list_i), list(a["strides"].list_i),
                         a["padding"].s.decode(), "max" if op == "MaxPool" else "avg")
        if op == "Concat":      # axis first (TF1)
            return torch.cat([ref(i) for i in ins[1:]], dim=int(self._const_int(ins[0])))
        if op == "ConcatV2":    # axis last
            return torch.cat([ref(i) for i in ins[:-1]], dim=int(self._const_int(ins[-1])))
        if op == "Reshape":
            # Batch-size generalization (inception_tf13.py:188-199 patches the
            # shapes so that batch > 1 works): a leading 1 becomes -1.
            shape = [int(s) for s in self._const_int(ins[1])]
            if shape and shape[0] == 1:
                shape[0] = -1
            return ref(ins[0]).reshape(shape)
        if op == "MatMul":
            x, y = ref(ins[0]), ref(ins[1])
            if "transpose_a" in a and a["transpose_a"].b:
                x = x.T
            if "transpose_b" in a and a["transpose_b"].b:
                y = y.T
            return x @ y
        if op == "BiasAdd":
            return ref(ins[0]) + ref(ins[1])
        if op == "Softmax":
            return torch.softmax(ref(ins[0]), dim=-1)
        if op == "Squeeze":
            dims = list(a["squeeze_dims"].list_i) if "squeeze_dims" in a else []
            x = ref(ins[0])
            if not dims:
                return x.squeeze()
            for d in sorted((d % x.dim() for d in dims), reverse=True):
                x = x.squeeze(d)
            return x
        raise NotImplementedError(f"op {op} (node {node.name})")


def _torch_dtype(attr) -> torch.dtype:
    if attr is None or attr.type is None:
        return torch.float32
    return torch.from_numpy(np.zeros(0, DTYPES.get(attr.type, np.float32))).dtype


class OfficialTF1Evaluator:
    """pool_3 features and the 1008-way softmax of the frozen 2015 graph,
    on ``device`` (CUDA unless named).

    ``pb_path`` (or ``$ICGAN_TF_INCEPTION_PB``) names a local
    ``classify_image_graph_def.pb``; the reference downloads it
    (``inception_tf13.py:40-42``), nothing is downloaded here.

    Images: NHWC float in [0, 255] (the reference's ``np.uint8(255*(x+1)/2)``
    hop happens in ``evaluate_images``)."""

    def __init__(self, pb_path: Optional[str] = None, device=None):
        pb_path = pb_path or os.environ.get("ICGAN_TF_INCEPTION_PB")
        if not pb_path or not os.path.exists(pb_path):
            raise FileNotFoundError(
                "classify_image_graph_def.pb not found: set $ICGAN_TF_INCEPTION_PB to a "
                "local copy (the reference downloads inception-2015-12-05.tgz; nothing is "
                "downloaded here)")
        with open(pb_path, "rb") as f:
            nodes = parse_graphdef(f.read())
        self.exe = TFGraphExecutor(nodes, feed="ExpandDims", fetches=["pool_3"], device=device)
        self.device = self.exe.device
        # The reference rebuilds logits = pool3 @ W with W from the graph
        # (inception_tf13.py:183-186), no bias.
        w = self.exe.const(self.exe.nodes["softmax/logits/MatMul"].inputs[1])
        self.w = torch.from_numpy(np.array(w)).to(self.device)

    def __call__(self, images_255) -> Tuple[np.ndarray, np.ndarray]:
        """→ (pool (N, 2048), softmax (N, 1008)) as float32 numpy arrays."""
        with torch.inference_mode(), full_f32():
            x = torch.as_tensor(images_255, dtype=torch.float32, device=self.device)
            pool = self.exe(x)[0]
            pool = pool.reshape(pool.shape[0], -1)
            preds = torch.softmax(pool @ self.w, dim=-1)
        return pool.cpu().numpy(), preds.cpu().numpy()


def official_inception_score(preds: np.ndarray, splits: int = 10) -> Tuple[float, float]:
    """The reference's split-KL IS (``inception_tf13.py:148-159``)."""
    scores = []
    n = preds.shape[0]
    for i in range(splits):
        part = preds[i * n // splits:(i + 1) * n // splits]
        kl = part * (np.log(part) - np.log(np.mean(part, 0, keepdims=True)))
        scores.append(np.exp(np.mean(np.sum(kl, 1))))
    return float(np.mean(scores)), float(np.std(scores))


def evaluate_images(evaluator: OfficialTF1Evaluator, images: np.ndarray, batch: int = 100,
                    normalize: bool = True, splits: int = 10) -> Dict[str, np.ndarray]:
    """images NHWC; ``normalize`` maps [-1, 1] → uint8 [0, 255] as
    ``inception_tf13.py:132-135`` does.  Returns IS, the pool activations and
    their moments."""
    if normalize:
        images = np.uint8(255 * (np.asarray(images) + 1) / 2.0)
    images = np.asarray(images, np.float32)
    pools, preds = [], []
    for i in range(int(math.ceil(len(images) / batch))):
        p, s = evaluator(images[i * batch:(i + 1) * batch])
        pools.append(p)
        preds.append(s)
    pools = np.concatenate(pools)
    preds = np.concatenate(preds)
    is_mean, is_std = official_inception_score(preds, splits)
    return {"IS_mean": is_mean, "IS_std": is_std, "pool": pools,
            "mu": np.mean(pools, axis=0), "sigma": np.cov(pools, rowvar=False)}
