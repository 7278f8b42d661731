"""The observability plane's seams (counterpart of
``mythril_tpu/observability``)."""
