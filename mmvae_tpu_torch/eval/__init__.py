"""Evaluation of trained models: generation, coherence, conditional FID
and importance-sampled likelihoods (mmvae_tpu/eval)."""
