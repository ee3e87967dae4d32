from .objectives import (  # noqa: F401
    ModelSpec, m_dreg_looser, m_elbo_nf, m_jmvae_nf, m_self_built, m_telbo_nf, resolve,
)
