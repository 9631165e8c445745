"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W power limit): HBM3 bytes/s and FLOP/s by input type. A
share of a peak is stated against these, with the card's power limit
(printed by every run) beside it."""

HBM_BYTES_PER_S = 3.35e12
FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
