"""Seeded violations for obs-in-hot-path."""


class Engine:
    # tpudp: hot-path
    def step(self):
        with self.obs.span("decode"):         # finding: allocates
            self.obs.event("tick", n=1)       # finding: allocates
