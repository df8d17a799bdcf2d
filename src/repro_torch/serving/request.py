"""Request lifecycle for the serving engine (copy of
``repro.serving.request``, without the re-dispatch state of the replica
pool, which comes with its slice)."""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class State(enum.Enum):
    WAITING = "waiting"        # admitted to queue, no KV yet
    PREFILL = "prefill"        # chunked prefill in progress
    DECODE = "decode"          # generating
    FINISHED = "finished"
    DISCARDED = "discarded"    # OOM victim (paper §4.4: rare reclaim)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int
    arrival: float = 0.0
    eos_id: Optional[int] = None

    state: State = State.WAITING
    prefill_done: int = 0              # tokens prefilled so far (chunked)
    output: list[int] = dataclasses.field(default_factory=list)
    slot: int = -1                     # engine cache slot while active
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    # async EOS (paper §5.3): EOS seen at iter i is acted on at iter i+1
    pending_eos: bool = False
    # prompt tokens *launched* into the model; leads ``prefill_done`` by the
    # in-flight iterations when the engine pipelines
    prefill_launched: int = 0
    # sampled tokens launched but not yet committed
    inflight: int = 0

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def context_len(self) -> int:
        return self.prefill_done + len(self.output)

    @property
    def prefill_remaining(self) -> int:
        return self.prompt_len - self.prefill_done

    @property
    def prefill_unlaunched(self) -> int:
        """Prompt tokens not yet launched — what the next plan can chunk."""
        return self.prompt_len - self.prefill_launched

    @property
    def total_tokens(self) -> int:
        return self.prompt_len + len(self.output)

    def predicted_final_len(self, avg_decode: float) -> int:
        """Peak-memory estimator input (§4.4): assume avg decode length."""
        want = max(int(avg_decode), 1)
        return self.prompt_len + min(self.max_new_tokens, max(want, 1))
