"""repro_torch.models — the LM side of the port (serving and training).

``config`` (``ModelConfig``), ``layers`` (RMSNorm, RoPE, attention on the
``local_attention`` kernel in prefill), ``mlp`` (the dense FFN and the
capacity MoE), ``recurrent`` (RG-LRU and RWKV-6 on the ``rglru_scan`` and
``wkv6`` kernels), ``transformer`` (``init_model``, ``forward``, ``init_cache``,
``prefill``, ``decode_step``) and ``convert`` (the JAX package's
parameter tree onto the port's modules).
"""
