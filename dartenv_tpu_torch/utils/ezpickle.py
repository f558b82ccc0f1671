"""EzPickle (reference: `gym/utils/ezpickle.py` † — SURVEY.md §2.1; used
by every dart env for re-init pickling)."""


class EzPickle(object):
    """Objects that are pickled/unpickled via their constructor arguments.

    Usage: in your class, call
        EzPickle.__init__(self, arg1, arg2, kw=...)
    with exactly the constructor arguments.  This is what makes envs
    holding unpicklable handles (jitted functions, device arrays)
    picklable: the pickle payload is just the ctor args.
    """

    def __init__(self, *args, **kwargs):
        self._ezpickle_args = args
        self._ezpickle_kwargs = kwargs

    def __getstate__(self):
        return {
            "_ezpickle_args": self._ezpickle_args,
            "_ezpickle_kwargs": self._ezpickle_kwargs,
        }

    def __setstate__(self, d):
        out = type(self)(*d["_ezpickle_args"], **d["_ezpickle_kwargs"])
        self.__dict__.update(out.__dict__)
