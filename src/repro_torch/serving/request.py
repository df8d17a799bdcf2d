"""Request lifecycle for the serving engine (copy of
``repro.serving.request``), with the replica pool's re-dispatch state
(DESIGN.md §14)."""
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
    REJECTED = "rejected"      # shed by SLO admission control (DESIGN.md §14)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int
    arrival: float = 0.0
    eos_id: Optional[int] = None
    # multi-turn session key (DESIGN.md §14): the router pins a session to
    # one replica so follow-up turns land on their prefix-cached KV
    session: Optional[int] = None

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
    # ---- fault-tolerant re-dispatch (DESIGN.md §14) ------------------------
    # prompt length as the user submitted it, set on the first checkpoint
    # (``checkpoint_redispatch``); None: never re-dispatched
    orig_prompt_len: Optional[int] = None
    # pool-level retries (timeout or failure re-dispatch), the shed reason
    # when admission rejects the request, and the replica it last ran on
    retries: int = 0
    reject_reason: Optional[str] = None
    replica: Optional[int] = None

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

    @property
    def generated(self) -> list[int]:
        """Every token this request generated, those committed before a
        failure and replayed as a forced prefix included: ``output`` for a
        request never re-dispatched."""
        if self.orig_prompt_len is None:
            return list(self.output)
        return list(self.prompt[self.orig_prompt_len:]) + list(self.output)

    def checkpoint_redispatch(self) -> int:
        """Fold every committed output token into the prompt as a forced
        replay prefix and clear the engine-local state (slot, launch
        counters, in-flight samples: they died with the replica).  Greedy
        samples depend on the prefix only, and the stochastic sampler's
        keys fold (rid, position) only, so the resumed generation is
        token-exact.  Returns the number of tokens folded.

        A request whose committed output already holds EOS, or whose token
        budget is spent, has nothing left to generate: it finishes here
        (stripped to EOS as the engine's finalize strips it) and must not
        be re-dispatched."""
        if self.orig_prompt_len is None:
            self.orig_prompt_len = len(self.prompt)
        out = list(self.output)
        if self.eos_id is not None and self.eos_id in out:
            out = out[: out.index(self.eos_id) + 1]
            self.prompt = list(self.prompt) + out
            self.output = []
            self.state = State.FINISHED
            self.pending_eos = False
            self.inflight = 0
            return 0
        folded = len(out)
        self.prompt = list(self.prompt) + out
        self.max_new_tokens -= folded
        self.output = []
        self.prefill_done = 0
        self.prefill_launched = 0
        self.inflight = 0
        self.slot = -1
        self.pending_eos = False
        if self.max_new_tokens <= 0:
            self.state = State.FINISHED
            return 0
        self.state = State.WAITING
        return folded
