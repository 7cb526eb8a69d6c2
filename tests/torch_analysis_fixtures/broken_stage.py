"""A stage whose fill publishes into another stage's result slot
(C008): the L2 TLB's eviction, overwritten from Victima's fill."""


class ThiefStage:
    name = "victima"
    past_l2 = True

    def lookup(self, cfg, st, req, need):
        return None

    def fill(self, cfg, st, req, out):
        out[self.name].info["n_bg"] = 0          # its own slot: clean
        out["l2_tlb"].info["ev_valid"] = None    # C008: a foreign slot
