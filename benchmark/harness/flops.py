"""The floating-point operations a BUTD-DETR step needs, counted from the
configuration's widths (2 per multiply-add of every matrix product and
attention; elementwise work, normalisations, the loss and the evaluators
left out, which puts the count below what the step does).

A training step runs the forward of every part and the backward of the
trainable ones (about twice their forward: the products against the inputs
and against the weights); RoBERTa is frozen and runs forward only. The text
positions count at the padded length the program computes.
"""

from typing import Dict

from benchmark.harness.spec import shape_names


def _mlp(rows, widths):
    return 2 * rows * sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def _attn(Lq, Lk, d):
    """An attention block: q, k, v, out projections and the two products."""
    return 2 * d * d * (2 * Lq + 2 * Lk) + 4 * Lq * Lk * d


def forward_flops(config: Dict) -> Dict[str, float]:
    """{"text": the frozen tower's, "rest": the trainable parts'} forward
    operations for one scene."""
    n = shape_names(config, 1, 0.0)
    m = config["model"]
    d, FF, L, V, Q, G = n["d"], n["FF"], n["L"], n["np1"], n["Q"], n["D"]
    c0 = 3 + n["C0"]
    sa = [(n["np0"] * n["ns0"], [c0, 64, 64, 128]),
          (n["np1"] * n["ns1"], [131, 128, 128, 256]),
          (n["np2"] * n["ns2"], [259, 128, 128, 256]),
          (n["np3"] * n["ns3"], [259, 128, 128, 256])]
    backbone = sum(_mlp(r, w) for r, w in sa)
    backbone += _mlp(n["np2"], [512, 256, 256]) + _mlp(V, [512, 256, d])
    rd, rff = n["rd"], n["rff"]
    text = n["rl"] * (_attn(L, L, rd) + _mlp(L, [rd, rff, rd]))
    rest = backbone + _mlp(L, [rd, d])  # the text projector
    if m["butd"]:
        rest += _mlp(G, [6, m["box_emb_dim"], m["box_emb_dim"]])
        rest += _mlp(G, [m["text_hidden"], d - m["box_emb_dim"]])
    rest += _mlp(V, [3, d, d])  # the position embedding
    enc = (_attn(V, V, d) + _attn(L, L, d) + _attn(L, V, d)
           + _attn(V, L, d) + _mlp(L, [d, FF, d]) + _mlp(V, [d, FF, d]))
    if m["butd"]:
        enc += _attn(V, G, d)
    rest += n["enc"] * enc
    rest += _mlp(L, [d, d, d, 64])  # the text's contrastive projection
    rest += _mlp(V, [d, d, d, 1])  # the objectness scores
    head = _mlp(Q, [d, d, d, 3]) * 2 + _mlp(Q, [d, d, d, n["NC"]])
    rest += _mlp(Q, [d, d]) + head  # query projection, proposal head
    dec = (_mlp(Q, [6, d, d]) + _attn(Q, Q, d) + _attn(Q, L, d)
           + _attn(Q, V, d) + _mlp(Q, [d, FF, d]) + head)
    if m["butd"]:
        dec += _attn(Q, G, d)
    rest += n["dec"] * dec
    rest += _mlp(n["P"] * Q, [d, d, d, 64])  # the queries' projection
    return {"text": float(text), "rest": float(rest)}


def scene_flops(config: Dict, training: bool) -> float:
    f = forward_flops(config)
    return f["text"] + (3.0 if training else 1.0) * f["rest"]
