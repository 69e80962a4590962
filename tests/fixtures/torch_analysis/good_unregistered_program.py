"""The corrected twin: only registered kinds, no new factory or
capture."""
# tpudp: program-module


class Engine:
    def _device(self, kind, fn, *args):
        return fn(*args)

    def go(self, fn):
        return self._device("decode", fn)
