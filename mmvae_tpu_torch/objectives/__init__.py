from .objectives import (  # noqa: F401
    OBJECTIVES, ModelSpec, dreg, elbo, iwae, m_dreg_looser, m_elbo_nf, m_jmvae, m_jmvae_nf,
    m_multi_elbos, m_self_built, m_svae, m_telbo, m_telbo_nf, m_vaevae_kl, m_vaevae_w2, resolve,
)
