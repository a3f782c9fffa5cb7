"""repro_torch.models — the LM side of the port (serving).

``config`` (``ModelConfig``), ``layers`` (RMSNorm, RoPE, attention on the
``local_attention`` kernel in prefill), ``mlp`` (the dense FFN),
``transformer`` (``init_model``, ``forward``, ``init_cache``,
``prefill``, ``decode_step``) and ``convert`` (the JAX package's
parameter tree onto the port's modules).
"""
