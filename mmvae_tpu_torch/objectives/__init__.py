from .objectives import ModelSpec, m_dreg_looser, m_elbo_nf, m_jmvae_nf, resolve  # noqa: F401
