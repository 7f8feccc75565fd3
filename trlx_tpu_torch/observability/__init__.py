"""Request tracing (`tracing`) and SLO burn-rate evaluation (`slo`),
copied from the JAX package (both are framework-free)."""
