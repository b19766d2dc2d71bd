"""Frozen count of a frame's model FLOPs: two operations per multiply-add
of every convolution, the 1x1 convolutions of (inverse) GDN included,
elementwise work left out, as ``torch.utils.flop_counter`` counts the
RD forward (FullNet.forward_frame).  The frame is padded to a multiple
of 64 first, as the codec pads it.

``part="encode"`` counts what an encode runs per frame (both nets'
analysis, hyper-analysis, hyper-synthesis, shortcut and synthesis: the
forward); ``part="decode"`` what a decode runs (hyper-synthesis,
shortcut and synthesis).
"""

from __future__ import annotations

from typing import Dict

PAD = 64
I, P, B = 0, 1, 2


def _conv(cin, cout, k, px):
    return 2 * cin * cout * k * k * px


def _attention(c, px):
    return 12 * _conv(c, c, 3, px) + _conv(c, c, 1, px)


def _analysis(cin, c, cout, k, h, w, attention):
    """g_a / g_a_ref: four stride-2 convs, GDN after the first three."""
    f, ch = 0, cin
    for i, out in enumerate((c, c, c, cout)):
        px = (h >> (i + 1)) * (w >> (i + 1))
        f += _conv(ch, out, k, px)
        if i < 3:
            f += _conv(out, out, 1, px)
        if i == 1 and attention:
            f += _attention(c, px)
        ch = out
    return f


def _synthesis(cin, c, cout, k, h, w, attention):
    """g_s: four x2 up-blocks (a conv to 4x channels, then IGDN on the
    first three), attention after the first."""
    f, ch = 0, cin
    for i, out in enumerate((c, c, c, cout)):
        px_in = (h >> (4 - i)) * (w >> (4 - i))
        f += _conv(ch, 4 * out, k, px_in)
        if i < 3:
            f += _conv(out, out, 1, 4 * px_in)
        if i == 0 and attention:
            f += _attention(c, 4 * px_in)
        ch = out
    return f


def _hyper_analysis(c, h, w):
    y, z = c["nb_ft_y"], c["nb_ft_z"]
    return (_conv(y, z, 3, (h >> 4) * (w >> 4)) + _conv(z, z, 5, (h >> 5)
            * (w >> 5)) + _conv(z, z, 5, (h >> 6) * (w >> 6)))


def _hyper_synthesis(c, h, w):
    y, z = c["nb_ft_y"], c["nb_ft_z"]
    return (_conv(z, 4 * y, 5, (h >> 6) * (w >> 6))
            + _conv(y, 4 * y, 5, (h >> 5) * (w >> 5))
            + _conv(y, 2 * y, 3, (h >> 4) * (w >> 4)))


def net_flops(c: Dict, h: int, w: int, shortcut: bool, part: str) -> int:
    att = c.get("use_attention", True)
    k = c.get("k_size", 5)
    f = _hyper_synthesis(c, h, w) + _synthesis(
        c["nb_ft_y"] + c["out_c_shortcut_y"], c["nb_ft"], c["out_c"], k,
        h, w, att)
    if shortcut and c["in_c_shortcut"] > 0:
        f += _analysis(c["in_c_shortcut"], c["nb_ft"], c["out_c_shortcut_y"],
                       k, h, w, False)
    if part == "encode":
        f += _analysis(c["in_c"], c["nb_ft"], c["nb_ft_y"], k, h, w, att)
        f += _hyper_analysis(c, h, w)
    return f


def frame_flops(model: Dict, frame_type: int, height: int, width: int,
                part: str = "encode") -> int:
    """Model FLOPs of one frame of ``frame_type`` at height x width."""
    if part not in ("encode", "decode"):
        raise ValueError(f"unknown part {part!r}")
    h = -(-height // PAD) * PAD
    w = -(-width // PAD) * PAD
    f = net_flops(model["codecnet"], h, w, frame_type != I, part)
    if frame_type != I:
        f += net_flops(model["mofnet"], h, w, frame_type == B, part)
    return f
