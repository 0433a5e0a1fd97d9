"""``pack_s.train``: seconds the set-up's packing of both sides' histories
takes (``models/als.py::pack_ratings_cached``, a miss), host clock ending
in a synchronize."""


def read(run):
    return run.setup.get("pack_s")
