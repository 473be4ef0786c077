"""Named workflow DAGs over the data lake (paper §III.C + §VII).

A workflow is a DAG of *stages*; each stage is a compute Interest whose
inputs are data-lake names — raw datasets or upstream stage outputs — and
whose output is published under its digest-derived result name
(:func:`repro_torch.core.jobs.result_name_for`).  Because a stage's canonical
job name includes its application, parameters and input names, the whole
DAG's result names are computable *before anything runs*: downstream
stages reference upstream outputs by name, identical sub-computations in
different workflows share one result object, and a re-submitted workflow
is served stage-by-stage from the result cache.

Scatter–gather is first-class: a stage with ``fanout=K`` expands into K
instances (``part=i`` in the job fields), each a distinct name the
forwarding strategies place independently — the "map a stage over dataset
segments fanned out to multiple clusters" pattern; a downstream stage
with ``fanout=1`` gathers all K outputs as its inputs.

The port's copy of ``repro/workflow/dag.py``: the same logic, its imports
pointing inside ``repro_torch``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from ..core.jobs import (INPUTS_FIELD, PRIORITY_FIELD, JobSpec,
                         encode_input_names, result_name_for)
from ..core.names import Name, canonical_job_name

__all__ = ["WorkflowError", "StageSpec", "StageInstance", "Workflow",
           "WorkflowSpec"]

REF_PREFIX = "@"   # inputs starting with '@' reference an upstream stage


class WorkflowError(ValueError):
    """Malformed workflow: cycle, unknown reference, bad fanout, ..."""


@dataclass(frozen=True)
class StageSpec:
    """One logical stage: an application over named inputs."""

    stage: str                       # unique within the workflow
    app: str                         # gateway application ("wf-align", ...)
    inputs: Tuple[str, ...] = ()     # "/lidc/data/..." or "@upstream-stage"
    fanout: int = 1                  # >1 = scatter into `fanout` instances
    params: Mapping[str, Any] = field(default_factory=dict)

    def refs(self) -> List[str]:
        return [i[1:] for i in self.inputs if i.startswith(REF_PREFIX)]


@dataclass(frozen=True)
class StageInstance:
    """A schedulable unit: one (stage, part) with fully resolved names."""

    id: str                          # "align.3" / "merge"
    stage: str                       # logical stage name
    fields: Mapping[str, Any]        # complete job fields (app, in=, part=…)
    deps: Tuple[str, ...]            # instance ids that must complete first
    request_name: Name               # canonical compute Interest name
    result_name: Name                # digest-derived data-lake output name

    @property
    def signature(self) -> str:
        return JobSpec(app=str(self.fields["app"]),
                       fields={k: v for k, v in self.fields.items()
                               if k != "app"}).signature()


@dataclass
class Workflow:
    """A compiled workflow: topologically ordered stage instances."""

    name: str
    instances: Dict[str, StageInstance]     # insertion order == topo order

    def __len__(self) -> int:
        return len(self.instances)

    def dependents(self) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {i: [] for i in self.instances}
        for inst in self.instances.values():
            for d in inst.deps:
                out[d].append(inst.id)
        return out

    def sinks(self) -> List[StageInstance]:
        dep = self.dependents()
        return [self.instances[i] for i, lst in dep.items() if not lst]

    def result_names(self) -> Dict[str, Name]:
        return {i: inst.result_name for i, inst in self.instances.items()}


class WorkflowSpec:
    """Declares a workflow DAG stage by stage.

    ::

        wf = WorkflowSpec("blast-pipeline")
        wf.stage("shard", "wf-shard", inputs=["/lidc/data/reads"], parts=8)
        wf.stage("align", "wf-align", inputs=["@shard"], fanout=8)
        wf.stage("merge", "wf-merge", inputs=["@align"])
        workflow = wf.compile()
    """

    def __init__(self, name: str = "workflow", priority: int = 0):
        """``priority`` is the workflow's scheduling class: every stage
        inherits it as a ``prio=`` job field (part of the canonical
        name) unless the stage sets its own; the compute-plane scheduler
        dispatches — and may preempt — by it."""
        self.name = name
        self.priority = int(priority)
        self._stages: Dict[str, StageSpec] = {}

    def stage(self, stage: str, app: str, *,
              inputs: Sequence[str] = (), fanout: int = 1,
              **params: Any) -> "WorkflowSpec":
        if stage in self._stages:
            raise WorkflowError(f"duplicate stage name {stage!r}")
        if fanout < 1:
            raise WorkflowError(f"stage {stage!r}: fanout must be >= 1")
        for i in inputs:
            if not (str(i).startswith("/") or str(i).startswith(REF_PREFIX)):
                raise WorkflowError(
                    f"stage {stage!r}: input {i!r} must be a /data name "
                    f"or an @stage reference")
        self._stages[stage] = StageSpec(stage=stage, app=app,
                                        inputs=tuple(str(i) for i in inputs),
                                        fanout=int(fanout), params=dict(params))
        return self

    # ------------------------------------------------------------- compile
    def _topo_order(self) -> List[StageSpec]:
        """Deterministic Kahn topological sort (insertion order ties)."""
        indeg: Dict[str, int] = {}
        for s in self._stages.values():
            for r in s.refs():
                if r not in self._stages:
                    raise WorkflowError(
                        f"stage {s.stage!r} references unknown stage @{r}")
            indeg[s.stage] = len(set(s.refs()))
        order: List[StageSpec] = []
        ready = [s for s in self._stages.values() if indeg[s.stage] == 0]
        dependents: Dict[str, List[str]] = {n: [] for n in self._stages}
        for s in self._stages.values():
            for r in set(s.refs()):
                dependents[r].append(s.stage)
        while ready:
            s = ready.pop(0)
            order.append(s)
            for d in dependents[s.stage]:
                indeg[d] -= 1
                if indeg[d] == 0:
                    ready.append(self._stages[d])
        if len(order) != len(self._stages):
            cyclic = sorted(n for n, d in indeg.items() if d > 0)
            raise WorkflowError(f"workflow has a cycle through {cyclic}")
        return order

    def _instance_inputs(self, spec: StageSpec, part: Optional[int],
                         done: Dict[str, List[StageInstance]]
                         ) -> Tuple[List[Name], List[str]]:
        """Resolve a stage instance's inputs to concrete names + dep ids."""
        names: List[Name] = []
        deps: List[str] = []
        for i in spec.inputs:
            if not i.startswith(REF_PREFIX):
                names.append(Name.parse(i))
                continue
            ups = done[i[1:]]
            if len(ups) > 1 and spec.fanout > 1:
                # element-wise scatter chaining requires equal widths
                if len(ups) != spec.fanout:
                    raise WorkflowError(
                        f"stage {spec.stage!r} (fanout={spec.fanout}) cannot "
                        f"consume @{i[1:]} (fanout={len(ups)}) element-wise")
                assert part is not None
                names.append(ups[part].result_name)
                deps.append(ups[part].id)
            elif spec.fanout > 1:
                # broadcast one upstream output to every scatter instance
                names.append(ups[0].result_name)
                deps.append(ups[0].id)
            else:
                # gather: every upstream instance's output is an input
                for u in ups:
                    names.append(u.result_name)
                    deps.append(u.id)
        return names, deps

    def compile(self) -> Workflow:
        """Validate, expand scatter stages and resolve all names."""
        instances: Dict[str, StageInstance] = {}
        by_stage: Dict[str, List[StageInstance]] = {}
        for spec in self._topo_order():
            parts = range(spec.fanout) if spec.fanout > 1 else [None]
            insts: List[StageInstance] = []
            for part in parts:
                fields: Dict[str, Any] = {"app": spec.app, **spec.params}
                if self.priority and PRIORITY_FIELD not in fields:
                    fields[PRIORITY_FIELD] = self.priority
                if part is not None:
                    fields["part"] = part
                    fields["parts"] = spec.fanout
                names, deps = self._instance_inputs(spec, part, by_stage)
                if names:
                    fields[INPUTS_FIELD] = encode_input_names(names)
                jspec = JobSpec(app=spec.app,
                                fields={k: v for k, v in fields.items()
                                        if k != "app"})
                inst = StageInstance(
                    id=spec.stage if part is None else f"{spec.stage}.{part}",
                    stage=spec.stage,
                    fields=fields,
                    deps=tuple(dict.fromkeys(deps)),
                    request_name=canonical_job_name(fields),
                    result_name=result_name_for(jspec))
                instances[inst.id] = inst
                insts.append(inst)
            by_stage[spec.stage] = insts
        return Workflow(name=self.name, instances=instances)
