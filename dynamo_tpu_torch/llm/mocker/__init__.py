"""The mock engine (a fake engine with real scheduling and KV accounting)
and the KV event types every engine shares. Port of `dynamo_tpu/llm/mocker`.

`MockEngine` / `MockEngineArgs` load on first use: the mock engine stands on
the engine's scheduler policy, and the KV event types alone (which the
frontend's router and every worker import) must not pull the engine in.
"""

from .kv_manager import KvManager

__all__ = ["MockEngine", "MockEngineArgs", "KvManager"]


def __getattr__(name):
    if name in ("MockEngine", "MockEngineArgs"):
        from . import engine

        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
