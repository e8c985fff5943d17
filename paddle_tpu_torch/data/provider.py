"""Declarative data providers — the @provider decorator: a copy of
`paddle_tpu/data/provider.py` for the port (it has no JAX in it).

Reference: python/paddle/trainer/PyDataProvider2.py:329 (@provider with
input_types, cache modes, should_shuffle, init_hook, calc_batch_size)
driving the C++ PyDataProvider2 (gserver/dataproviders/
PyDataProvider2.cpp:70-235). Here the provider is a plain reader
factory: `process(file_list)` returns a reader over all files, with the
same per-pass in-memory cache and shuffle semantics; input types come
from data.feeder and the resulting samples feed DataFeeder directly.
"""

from __future__ import annotations

import random as _random
from typing import Callable, List, Optional, Sequence


class CacheType:
    NO_CACHE = 0
    CACHE_PASS_IN_MEM = 1  # cache samples after the first pass


class _Settings:
    """Mutable bag passed to init_hook and the process function
    (PyDataProvider2.py settings object): carries input_types plus
    whatever init_hook attaches (dictionaries, vocab sizes, ...)."""

    def __init__(self, input_types, kwargs):
        self.input_types = input_types
        self.logger = __import__("logging").getLogger(
            "paddle_tpu_torch.data")
        for k, v in kwargs.items():
            setattr(self, k, v)

    # older reference providers (benchmark/paddle/image/provider.py)
    # call the field `slots`; keep both names as aliases
    @property
    def slots(self):
        return self.input_types

    @slots.setter
    def slots(self, v):
        self.input_types = v


class DataProvider:
    def __init__(
        self,
        fn: Callable,
        input_types,
        should_shuffle: Optional[bool] = None,
        cache: int = CacheType.NO_CACHE,
        init_hook: Optional[Callable] = None,
        skip_faulty_files: int = 0,
        **kwargs,
    ):
        self.fn = fn
        self.input_types = input_types
        self.should_shuffle = should_shuffle
        self.cache = cache
        self.init_hook = init_hook
        # data-pipeline robustness: a file whose process() raises
        # (corrupt/undecodable) is SKIPPED with a counted warning, up
        # to this budget per reader pass, instead of killing the whole
        # pass. 0 = strict (any decode error aborts — the historical
        # behavior). The granularity is per FILE because a raised user
        # generator cannot be resumed mid-record.
        self.skip_faulty_files = skip_faulty_files
        self.faulty_files_skipped = 0  # running total, across passes
        self.kwargs = kwargs
        # per-file-list cache: one decorated fn commonly serves both a
        # train and a test reader (PyDataProvider2 caches per provider
        # instance, which the C++ side creates per data source)
        self._cache_store: dict = {}

    def __call__(self, file_list, **hook_kwargs) -> Callable:
        """Returns a reader creator over `file_list` (a path or list)."""
        if isinstance(file_list, str):
            file_list = [file_list]
        settings = _Settings(self.input_types, self.kwargs)
        if self.init_hook is not None:
            self.init_hook(settings, file_list=file_list, **hook_kwargs)
        # init_hook may declare the types (settings.input_types or the
        # older settings.slots), as in PyDataProvider2.py:150-214
        if settings.input_types is None:
            raise ValueError(
                "provider has no input_types: pass them to @provider or "
                "set settings.input_types/settings.slots in init_hook"
            )
        self.input_types = settings.input_types
        shuffle = (
            self.should_shuffle
            if self.should_shuffle is not None
            else True
        )

        # key includes the hook kwargs: the same files can legitimately
        # be re-read under different init_hook settings (e.g. another
        # vocabulary) and must not serve stale samples
        cache_key = (
            tuple(file_list),
            repr(sorted(hook_kwargs.items())),
        )
        pass_counter = [0]
        use_cache = self.cache == CacheType.CACHE_PASS_IN_MEM

        def generate():
            skipped = 0
            for path in file_list:
                try:
                    yield from self.fn(settings, path)
                except Exception as e:
                    if skipped >= self.skip_faulty_files:
                        raise
                    skipped += 1
                    self.faulty_files_skipped += 1
                    settings.logger.warning(
                        "provider: skipping faulty file %s (%s: %s) — "
                        "%d/%d skips used this pass",
                        path, type(e).__name__, e, skipped,
                        self.skip_faulty_files,
                    )

        def reader():
            if not use_cache and not shuffle:
                # stream: larger-than-RAM datasets in O(1) memory
                yield from generate()
                return
            if use_cache and cache_key in self._cache_store:
                samples = list(self._cache_store[cache_key])
            else:
                samples = list(generate())
                if use_cache:
                    self._cache_store[cache_key] = list(samples)
            if shuffle:
                # deterministic but DIFFERENT order each pass (the
                # reference reshuffles per pass)
                _random.Random(0xC0FFEE + pass_counter[0]).shuffle(
                    samples
                )
                pass_counter[0] += 1
            yield from samples

        return reader


def provider(
    input_types=None,
    should_shuffle=None,
    cache: int = CacheType.NO_CACHE,
    init_hook: Optional[Callable] = None,
    skip_faulty_files: int = 0,
    **kwargs,
):
    """Decorator (PyDataProvider2.py:329):

        @provider(input_types=[dense_vector(784), integer_value(10)],
                  cache=CacheType.CACHE_PASS_IN_MEM)
        def process(settings, filename):
            for img, lbl in read(filename):
                yield img, lbl

    `skip_faulty_files=N` lets a pass survive up to N corrupt/
    undecodable files (counted warning per skip) instead of aborting.
    """
    assert input_types is not None or init_hook is not None, (
        "provider needs input_types (directly or set by init_hook)"
    )

    def deco(fn):
        return DataProvider(
            fn,
            input_types,
            should_shuffle=should_shuffle,
            cache=cache,
            init_hook=init_hook,
            skip_faulty_files=skip_faulty_files,
            **kwargs,
        )

    return deco
