"""Analysis-flag singleton (own copy of the flags of
``mythril_tpu/support/support_args.py`` that the solver funnel reads)."""


class Args:
    def __init__(self):
        self.word_probing = True     # host word-level model probing (CDCL tail)
        self.cone_decisions = True   # CDCL decisions restricted to query cone
        # below this many undecided lanes the native CDCL wins outright;
        # the funnel's structural floor is derived from it
        # (ops/batched_sat.effective_min_lanes)
        self.device_min_lanes = 8


args = Args()
