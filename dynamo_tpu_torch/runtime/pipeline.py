"""Generic bidirectional operator pipeline.

Port of `dynamo_tpu/runtime/pipeline.py`, unchanged.

The reference's pipeline framework (lib/runtime/src/pipeline.rs: PipelineIO
:88, Operator nodes with forward/backward edges under pipeline/nodes/,
composed by build_routed_pipeline common.rs:259-310) — the abstraction that
lets the serving chain

    SegmentSource -> Preprocessor.fwd -> Backend.fwd -> Migration.fwd ->
      ServiceBackend [network hop] -> Migration.bwd -> Backend.bwd ->
      Preprocessor.bwd -> frontend

be assembled from interchangeable nodes. Python redesign: an `Operator`
transforms the REQUEST on the way down (`forward`) and wraps the RESPONSE
STREAM on the way up (`backward`); `compose` folds a list of operators
around a sink into one `AsyncEngine`-shaped object. Operators that must
own the sink call entirely (retry loops like llm/migration.py) implement
`around` instead.
"""

from __future__ import annotations

import logging
from typing import Any, AsyncIterator, List, Optional, Sequence

from .engine import Context

logger = logging.getLogger(__name__)


class Operator:
    """One bidirectional pipeline node (reference Operator, pipeline.rs).

    Default implementations are pass-through; override any subset:
      * forward(request, context)  — transform the request going DOWN
      * backward(stream, request, context) — wrap the stream coming UP
      * around(next_engine, request, context) — own the sink call entirely
        (retry/migration semantics); when overridden, forward/backward of
        THIS node are not used.
    """

    async def forward(self, request: Any, context: Context) -> Any:
        return request

    def backward(
        self, stream: AsyncIterator[Any], request: Any, context: Context
    ) -> AsyncIterator[Any]:
        return stream

    def around(
        self, next_engine: "PipelineEngine", request: Any, context: Context
    ) -> Optional[AsyncIterator[Any]]:
        """Return a stream to take over the downstream call, or None to use
        the forward/backward path."""
        return None

    @property
    def name(self) -> str:
        return type(self).__name__


class ServiceBackend:
    """The sink: hands the (fully forward-transformed) request to an engine
    or router (reference ServiceBackend pipeline/nodes)."""

    def __init__(self, engine):
        self.engine = engine

    async def generate(self, request: Any, context: Context) -> AsyncIterator[Any]:
        stream = self.engine.generate(request, context)
        if hasattr(stream, "__await__"):
            stream = await stream
        async for item in stream:
            yield item


class PipelineEngine:
    """`compose(operators, sink)`: an AsyncEngine whose generate() runs
    request forward through each operator in order, calls the sink, then
    wraps the stream backward in reverse order."""

    def __init__(self, operators: Sequence[Operator], sink):
        self.operators: List[Operator] = list(operators)
        self.sink = sink

    def _tail(self, index: int) -> "PipelineEngine":
        """The sub-pipeline below operator `index` (for around())."""
        return PipelineEngine(self.operators[index + 1 :], self.sink)

    async def generate(self, request: Any, context: Context) -> AsyncIterator[Any]:
        async for item in self._run(0, request, context):
            yield item

    async def _run(
        self, index: int, request: Any, context: Context
    ) -> AsyncIterator[Any]:
        if index >= len(self.operators):
            async for item in self.sink.generate(request, context):
                yield item
            return
        op = self.operators[index]
        taken = op.around(self._tail(index), request, context)
        if taken is not None:
            async for item in taken:
                yield item
            return
        request = await op.forward(request, context)
        inner = self._run(index + 1, request, context)
        async for item in op.backward(inner, request, context):
            yield item


def compose(operators: Sequence[Operator], sink) -> PipelineEngine:
    """Fold operators around a sink (reference build_routed_pipeline
    common.rs:259-310 builds exactly this shape)."""
    return PipelineEngine(operators, sink)
