"""Language models of the co-located LM workloads (port of ``repro.models``).

The port carries the three families its serving path runs: the dense GQA
transformer (smollm), the Zamba2 hybrid (Mamba-2 layers with one shared
attention block) and RWKV-6 (rwkv6-7b).  Prefill attention runs the
``flash_attention`` kernel, every Mamba layer's prefill the ``ssd`` kernel
and every RWKV layer's prefill the ``wkv`` kernel.
"""
