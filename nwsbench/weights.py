"""The model's weights, drawn by the benchmark from the seed on the device
in three calls, as a tree in the JAX layout that both the port
(``NeuralWaveshaping.load_params``) and the plain reference take.

The draw follows the published model's initialisation as the port's
modules describe it: dense, GRU and shaper weights uniform within
+-1/sqrt(fan_in); LayerNorm scales 1 and biases 0; each shaper's input
scale N(0, 1) * 10; the reverb's impulse response N(0, 1) * 1e-6.
"""
import math
from typing import Dict, List, Tuple

import torch

Leaf = Tuple[Tuple, Tuple[int, ...], str, float]  # (path, shape, kind, scale)


def _mlp(path, n_in, hidden, n_out, depth) -> List[Leaf]:
    leaves = []
    for i in range(depth):
        a = n_in if i == 0 else hidden
        b = hidden if i < depth - 1 else n_out
        bound = 1.0 / math.sqrt(a)
        leaves += [(path + ("layers", i, "dense", "w"), (a, b), "u", bound),
                   (path + ("layers", i, "dense", "b"), (b,), "u", bound)]
        if i < depth - 1:
            leaves += [(path + ("layers", i, "norm", "scale"), (b,), "one", 1.0),
                       (path + ("layers", i, "norm", "bias"), (b,), "zero", 0.0)]
    return leaves


def leaves(m: Dict) -> List[Leaf]:
    """Every parameter of the model of sizes ``m``: (path, shape, kind, scale),
    kind "u" (uniform within +-scale), "n" (normal times scale), "one", "zero"."""
    gru, emb, ctl = m["gru_hidden_size"], m["control_embedding_size"], m["control_size"]
    h, c, w, d = m["n_harmonics"], m["n_waveshapers"], m["shaping_fn_size"], m["shaping_fn_depth"]
    out = m["out_channels"]
    g = 1.0 / math.sqrt(gru)
    spec: List[Leaf] = [
        (("embedding", "gru", "w_ih"), (ctl, 3 * gru), "u", g),
        (("embedding", "gru", "w_hh"), (gru, 3 * gru), "u", g),
        (("embedding", "gru", "b_ih"), (3 * gru,), "u", g),
        (("embedding", "gru", "b_hh"), (3 * gru,), "u", g),
        (("embedding", "proj", "w"), (gru, emb), "u", g),
        (("embedding", "proj", "b"), (emb,), "u", g),
        (("harmonic_mixer", "w"), (h, c), "u", 1.0 / math.sqrt(h)),
        (("harmonic_mixer", "b"), (c,), "u", 1.0 / math.sqrt(h)),
    ]
    spec += _mlp(("newt", "mlp"), emb, emb, 4 * c, m["film_mlp_depth"])
    spec.append((("newt", "shaping_fn", "input_scale"), (c,), "n", 10.0))
    for i in range(d):
        w_in, w_out = (1 if i == 0 else w), (w if i < d - 1 else 1)
        bound = 1.0 / math.sqrt(w_in)
        spec += [(("newt", "shaping_fn", "layers", i, "w"), (c, w_in, w_out), "u", bound),
                 (("newt", "shaping_fn", "layers", i, "b"), (c, w_out), "u", bound)]
    spec += [(("newt", "mixer", "w"), (c, out), "u", 1.0 / math.sqrt(c)),
             (("newt", "mixer", "b"), (out,), "u", 1.0 / math.sqrt(c))]
    spec += _mlp(("h_generator",), emb, m["noise_mlp_hidden_size"],
                 m["noise_ir_length"] // 2 + 1, m["noise_mlp_depth"])
    spec.append((("reverb", "ir"), (m["sample_rate"] * m["reverb_seconds"] - 1,), "n", 1e-6))
    return spec


def _put(tree: Dict, path: Tuple, value) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= key:
                node.append({})
            node = node[key]
            continue
        node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    if isinstance(node, list):
        while len(node) <= path[-1]:
            node.append(None)
    node[path[-1]] = value


def draw(m: Dict, seed: int, device) -> Dict:
    """The parameter tree of sizes ``m`` from ``seed``, drawn on ``device``
    with one generator there: one uniform and one normal call for all the
    leaves, sliced."""
    spec = leaves(m)
    gen = torch.Generator(device=device).manual_seed(seed)
    n_u = sum(math.prod(s) for _, s, k, _ in spec if k == "u")
    n_n = sum(math.prod(s) for _, s, k, _ in spec if k == "n")
    uniform = torch.rand(n_u, generator=gen, device=device) * 2.0 - 1.0
    normal = torch.randn(n_n, generator=gen, device=device)
    tree: Dict = {}
    at = {"u": 0, "n": 0}
    for path, shape, kind, scale in spec:
        if kind in at:
            n = math.prod(shape)
            src = uniform if kind == "u" else normal
            value = (src[at[kind]: at[kind] + n] * scale).reshape(shape)
            at[kind] += n
        else:
            value = torch.full(shape, 1.0 if kind == "one" else 0.0, device=device)
        _put(tree, path, value)
    return tree


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{"newt.mlp.layers.0.dense.w": tensor, ...} of a tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, torch.Tensor] = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)
