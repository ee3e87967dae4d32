"""Numerics constants (mmvae_tpu/core/constants.py)."""

import math

# Small epsilon added to every std parameterization (reference: utils.py:17).
ETA = 1e-6

LOG2PI = math.log(2.0 * math.pi)

# Bernoulli probability clamp: probabilities are clipped to
# [BERNOULLI_EPS, 1 - BERNOULLI_EPS] before their logs.
BERNOULLI_EPS = 1e-7
