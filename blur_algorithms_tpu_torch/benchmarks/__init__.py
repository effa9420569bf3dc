"""The probes of the JAX package's ``benchmarks/``, ported to the H100.

- ``mxu_dot_rate`` (B1): the tensor cores' dot rate, by ``mma.sync`` and by
  ``wgmma``, on a chain of int8 or bf16 products;
- ``fft_mxu_ablation`` (B2): K3/K3f with their stages left out one by one;
- ``dma_fetch_rate`` (B3): what K1's loaders fetch, with no band work.

Each runs as ``python -m blur_algorithms_tpu_torch.benchmarks.<name>`` on
the card (``--device cpu`` runs the plain versions) and prints JSON lines.
Their kernels (``csrc/probes/``) build into a library of their own
(``utils/build.load_probe_library``); no route of the port calls them.
"""
