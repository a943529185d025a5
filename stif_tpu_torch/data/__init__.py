"""Data sources of the port (counterpart of ``stif_tpu.data``)."""
