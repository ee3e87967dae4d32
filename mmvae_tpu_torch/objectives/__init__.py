from .objectives import ModelSpec, m_elbo_nf, resolve  # noqa: F401
