"""Language models of the co-located LM workloads (port of ``repro.models``).

This slice carries the two families the serving path needs: the dense
GQA transformer (smollm) and the Zamba2 hybrid (Mamba-2 layers with one
shared attention block).  Prefill attention runs the ``flash_attention``
kernel and every Mamba layer's prefill the ``ssd`` kernel.
"""
