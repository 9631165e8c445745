"""The ReLU of the attention blocks' feed-forward layer and of the MLP tower.

``relu`` is the one place either decides which entries pass, so a check can
hand one device's decisions to another, as it hands dropout masks: it puts
``torch.where(keep, z, 0.0)`` in its place, with ``keep`` recorded on one
device (``chip_smoke.DrawReplay``). That has ``torch.relu``'s values and
gradient.
"""

import torch


def relu(z):
    return torch.relu(z)
