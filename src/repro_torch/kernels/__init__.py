"""Hand-written Hopper kernels of the port, each beside its plain version.

| kernel | replaces | source |
| --- | --- | --- |
| ``runqlat_hist`` | ``repro/kernels/runqlat_hist.py::runqlat_hist_pallas`` | ``csrc/runqlat_hist.cu`` |
| ``rollout_tick`` | ``repro/kernels/rollout_tick.py::fused_tick`` | ``csrc/rollout_tick.cu`` |
| ``flash_attention`` | ``repro/kernels/flash_attention.py::flash_attention_pallas`` | ``csrc/flash_attention_sm90.cu`` (bf16), ``csrc/flash_attention_f32_sm90.cu`` (float32) |
| ``flash_attention_bwd`` | none: JAX's custom-VJP backward ``repro/models/attention.py::_flash_bwd`` (plain jnp) | ``csrc/flash_attention_bwd_sm90.cu`` (bf16), ``csrc/flash_attention_bwd_f32_sm90.cu`` (float32) |
| ``ssd`` | ``repro/kernels/ssd.py::ssd_pallas`` | ``csrc/ssd.cu`` |
| ``wkv`` | ``repro/kernels/rwkv_wkv.py::wkv_pallas`` | ``csrc/wkv.cu`` |
"""
