"""Host-side utilities of the port (counterpart of ``stif_tpu.utils``)."""
