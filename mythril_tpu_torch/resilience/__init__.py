"""The resilience plane's seams (counterpart of
``mythril_tpu/resilience``)."""
