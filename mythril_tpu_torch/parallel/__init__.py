"""The fleet and cross-process knowledge (own copy of the part of
``mythril_tpu/parallel`` that ``myth analyze`` reaches; the device mesh
of ``mesh.py`` is not ported).

- ``gossip``: frames, epoch stamps, and the solver channels frozen for
  another process (the knowledge store's records, the fleet's
  heartbeats and boundary gossip) and applied monotonically on arrival.
- ``fabric``: the authenticated transport (HMAC handshake, per-frame
  MACs, journals over the wire).
- ``coordinator``: the lease state machine (leases, heartbeats,
  re-lease, straggler split, epoch fence, gossip routing).
- ``fleet``: ``--workers N`` on the svm's transaction boundary, and the
  worker seat (``python -m mythril_tpu_torch.parallel.fleet --worker``).
"""
