"""Host-side data helpers (numpy). Counterpart of ``gsplat_tpu/data``; so
far only ``images.save_image``, which the orbit export writes with."""
