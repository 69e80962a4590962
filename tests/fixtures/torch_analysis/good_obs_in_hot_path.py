"""The corrected twin: the allocation-free API on the hot path."""


class Engine:
    # tpudp: hot-path
    def step(self):
        tok = self.obs.begin("decode")
        self.obs.count("ticks")
        self.obs.end(tok)

    def admit(self):
        self.obs.event("admit")               # off the hot path: fine
