"""Random weights from the seed, made on the device in the type they are
served in, in the layout the program's dense decoder takes (``embed``,
``head``, ``final_norm`` and one dict per block), and handed both to the
program and to the reference.

Every matrix is a view of one bf16 buffer filled by one ``normal_`` call
of a generator on the device, then scaled in place; the norms' scales
are one f32 buffer.  Scales: embeddings 1, products 1 / sqrt(fan in),
except q and k at sqrt(3 / d), so that attention scores spread with a
standard deviation of about 3 and a head attends to a few keys, not
evenly to thousands; norms' scales 0.1 x N(0, 1) around the norm's 1.
"""
from __future__ import annotations

import math

import torch


def dims(config: dict) -> dict:
    """The widths of a configuration file, under short names."""
    c = config
    H, d = c["num_attention_heads"], c["hidden_size"]
    return dict(L=c["num_hidden_layers"], d=d, H=H,
                Hkv=c["num_key_value_heads"],
                hd=c.get("head_dim") or d // H,
                f=c["intermediate_size"], V=c["vocab_size"])


def _shapes(m: dict) -> list:
    """(path, shape, std) of every matrix, in the buffer's order."""
    d, H, Hkv, hd, f, V = m["d"], m["H"], m["Hkv"], m["hd"], m["f"], m["V"]
    qk = math.sqrt(3.0 / d)
    out = [(("embed",), (V, d), 1.0), (("head",), (d, V), 1 / math.sqrt(d))]
    for i in range(m["L"]):
        out += [((i, "attn", "wq"), (d, H * hd), qk),
                ((i, "attn", "wk"), (d, Hkv * hd), qk),
                ((i, "attn", "wv"), (d, Hkv * hd), 1 / math.sqrt(d)),
                ((i, "attn", "wo"), (H * hd, d), 1 / math.sqrt(H * hd)),
                ((i, "mlp", "wg"), (d, f), 1 / math.sqrt(d)),
                ((i, "mlp", "wu"), (d, f), 1 / math.sqrt(d)),
                ((i, "mlp", "wd"), (f, d), 1 / math.sqrt(f))]
    return out


def make_weights(config: dict, seed: int, device) -> dict:
    m = dims(config)
    dtype = getattr(torch, config["torch_dtype"])
    shapes = _shapes(m)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 64))
    flat = torch.empty(sum(math.prod(s) for _, s, _ in shapes), dtype=dtype,
                       device=device)
    flat.normal_(generator=gen)
    norms = torch.empty((2 * m["L"] + 1, m["d"]), dtype=torch.float32,
                        device=device)
    norms.normal_(generator=gen).mul_(0.1)
    params = {"blocks": [{"attn": {}, "mlp": {},
                          "ln1": {"scale": norms[2 * i]},
                          "ln2": {"scale": norms[2 * i + 1]}}
                         for i in range(m["L"])],
              "final_norm": {"scale": norms[-1]}}
    at = 0
    for path, shape, std in shapes:
        n = math.prod(shape)
        w = flat[at:at + n].view(shape).mul_(std)
        at += n
        if len(path) == 1:
            params[path[0]] = w
        else:
            params["blocks"][path[0]][path[1]][path[2]] = w
    return params
