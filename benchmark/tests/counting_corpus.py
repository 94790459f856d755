"""A corpus module for the tests: ``benchmark.corpus``'s five functions of
the contract, each call counted in ``CALLS``. A configuration names it
under ``"corpus"`` as ``benchmark.tests.counting_corpus``."""

import collections

from benchmark import corpus

CALLS: collections.Counter = collections.Counter()


def _counted(name: str):
    def call(*args, **kwargs):
        CALLS[name] += 1
        return getattr(corpus, name)(*args, **kwargs)
    call.__name__ = name
    return call


draw_for = _counted("draw_for")
build_database = _counted("build_database")
generator_for = _counted("generator_for")
reference_for = _counted("reference_for")
stale_reference_for = _counted("stale_reference_for")
