"""The port's names and packets (``repro_torch.core.names``, ``packets``,
``reasons``, ``resilience``) against the reference's ``repro.core``, on
the same generated inputs: names, canonical job names, signatures, the
session and batch codecs, and the errors each refuses with."""

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import repro.core.jobs as J
import repro.core.names as N
import repro.core.reasons as R
import repro.core.resilience as RS
import repro_torch.core.jobs as TJ
import repro_torch.core.names as TN
import repro_torch.core.reasons as TR
import repro_torch.core.resilience as TRS
from repro.core.packets import Data, Interest, sign_data, verify_data
from repro_torch.core.packets import Data as TData
from repro_torch.core.packets import Interest as TInterest
from repro_torch.core.packets import sign_data as tsign_data
from repro_torch.core.packets import verify_data as tverify_data

SETTINGS = settings(max_examples=150, deadline=None, derandomize=True, database=None,
                    suppress_health_check=[HealthCheck.too_slow])

_key = st.text(alphabet="abcdefghijklmnopqrstuvwxyz_0123456789.-", min_size=1, max_size=8)
_word = st.text(alphabet="abcdefghijklmnopqrstuvwxyzABC0123456789_.-", min_size=1,
                max_size=10)
_value = st.one_of(st.integers(-10 ** 6, 10 ** 6), st.booleans(), _word,
                   st.floats(allow_nan=False, allow_infinity=False, width=32),
                   st.sampled_from([1.0, 2.0, 0.5, 16.0]))
_fields = st.dictionaries(_key.filter(lambda k: k not in ("app", "arch", "shape")),
                          _value, max_size=6)


def _both(fn_ref, fn_port, *args, **kw):
    """The two functions' results, or the exception type each raised."""
    out = []
    for fn in (fn_ref, fn_port):
        try:
            out.append(fn(*args, **kw))
        except Exception as e:              # noqa: BLE001 - compared below
            out.append(type(e).__name__)
    return out


@SETTINGS
@given(app=_word, arch=st.one_of(st.none(), _word), shape=st.one_of(st.none(), _word),
       fields=_fields)
def test_canonical_names_and_signatures_match_the_reference(app, arch, shape, fields):
    f = dict(fields, app=app)
    if arch is not None:
        f["arch"] = arch
    if shape is not None:
        f["shape"] = shape
    ref, port = _both(N.canonical_job_name, TN.canonical_job_name, f)
    assert str(ref) == str(port)
    if isinstance(ref, str):
        return
    assert ref.components == port.components
    assert N.job_fields_of(ref) == TN.job_fields_of(port)
    spec = {k: v for k, v in f.items() if k != "app"}
    rs, ps = J.JobSpec(app, spec), TJ.JobSpec(app, spec)
    assert rs.signature() == ps.signature()
    assert str(rs.name()) == str(ps.name())
    assert str(J.result_name_for(rs)) == str(TJ.result_name_for(ps))
    assert rs.priority == ps.priority
    for ref_fn, port_fn in ((rs.chips, ps.chips), (rs.steps, ps.steps)):
        ref, port = _both(ref_fn, port_fn)
        assert ref == port


@SETTINGS
@given(fields=_fields, transport=st.dictionaries(st.sampled_from(["spill", "avoid"]),
                                                 _word, max_size=2))
def test_transport_fields_leave_the_signature_alone(fields, transport):
    base = TJ.JobSpec("train", dict(fields))
    moved = TJ.JobSpec("train", dict(fields, **transport))
    assert base.signature() == moved.signature()
    assert moved.signature() == J.JobSpec("train", dict(fields, **transport)).signature()


@SETTINGS
@given(parts=st.lists(st.text(alphabet="abcXYZ019_.,=&-+%:/", min_size=0, max_size=6),
                      max_size=6))
def test_parse_and_name_algebra_match_the_reference(parts):
    uri = "/" + "/".join(parts)
    ref, port = _both(N.Name.parse, TN.Name.parse, uri)
    assert (ref if isinstance(ref, str) else ref.components) == \
        (port if isinstance(port, str) else port.components)
    if isinstance(ref, str):
        return
    assert str(ref) == str(port) and len(ref) == len(port)
    assert [p.components for p in ref.prefixes()] == [p.components for p in port.prefixes()]
    assert ref.append("x/y", "z").components == port.append("x/y", "z").components
    assert N.Name.of(*parts).components == TN.Name.of(*parts).components
    head = ref[:1]
    assert head.is_prefix_of(ref) == port[:1].is_prefix_of(port)


@SETTINGS
@given(model=_word, fields=_fields, lo=st.integers(-2, 50), width=st.integers(-1, 50))
def test_session_and_batch_codecs_match_the_reference(model, fields, lo, width):
    ref, port = _both(N.serve_session_name, TN.serve_session_name, model, fields)
    assert str(ref) == str(port)
    if not isinstance(ref, str):
        assert N.serve_fields_of(ref) == TN.serve_fields_of(port)
    f = dict(fields, app="map")
    ref, port = _both(N.batch_job_name, TN.batch_job_name, f, lo, lo + width)
    assert str(ref) == str(port)
    if not isinstance(ref, str):
        assert N.batch_fields_of(ref) == TN.batch_fields_of(port)


@pytest.mark.parametrize("component", [
    "a=1&b=2", "", "a=1&a=2", "novalue", "k=v=w", "x=&y=3", "a=1&&b=2"])
def test_parse_job_matches_the_reference(component):
    ref, port = _both(N.parse_job, TN.parse_job, component)
    assert ref == port


@pytest.mark.parametrize("bad", [{"bad key": 1}, {"k/v": 2}, {}, {"arch": "x"}])
def test_the_same_job_descriptions_are_refused(bad):
    ref, port = _both(N.canonical_job_name, TN.canonical_job_name, bad)
    assert (ref if isinstance(ref, str) else str(ref)) == \
        (port if isinstance(port, str) else str(port))


def test_name_caches_are_bounded_as_the_reference_bounds_them():
    stats = TN.name_cache_stats()
    try:
        TN.configure_name_caches(parse_capacity=4, job_capacity=3)
        for i in range(10):
            TN.Name.parse(f"/lidc/cache/probe{i}")
            TN.parse_job(f"i={i}")
        now = TN.name_cache_stats()
        assert now["parse_size"] <= 4 and now["job_size"] <= 3
        assert now["parse_evictions"] >= 6 and now["job_evictions"] >= 7
        # the port's caches are its own: the reference's are untouched
        assert N.name_cache_stats()["parse_capacity"] != 4
    finally:
        TN.configure_name_caches(parse_capacity=stats["parse_capacity"],
                                 job_capacity=stats["job_capacity"])


def test_reasons_and_retry_policies_match_the_reference():
    names = [n for n in dir(R) if n.isupper()]
    assert names == [n for n in dir(TR) if n.isupper()]
    assert all(getattr(R, n) == getattr(TR, n) for n in names)
    for reason in ("busy", "busy:overload", "validation:chips", "nack:no-route", "timeout",
                   "data-not-found", "weird:thing"):
        assert R.kind_of(reason) == TR.kind_of(reason)
    for n in ("NOROUTE_FAST_RETRY", "CONSUMER_EXPRESS", "SPILL_RETRY"):
        rp, tp = getattr(RS, n), getattr(TRS, n)
        assert [rp.delay(a, key="k") for a in range(1, 7)] == \
            [tp.delay(a, key="k") for a in range(1, 7)]


def test_signed_packets_verify_across_packages():
    name = N.Name.parse("/lidc/data/results/abc")
    d = sign_data(Data.from_json(name, {"x": 1}, created_at=1.0), b"k" * 16, "pod0")
    td = tsign_data(TData.from_json(TN.Name.parse(str(name)), {"x": 1}, created_at=1.0),
                    b"k" * 16, "pod0")
    assert (d.content, d.signature, d.signer) == (td.content, td.signature, td.signer)
    assert verify_data(d, b"k" * 16) and tverify_data(td, b"k" * 16)
    i, ti = Interest(name=name), TInterest(name=TN.Name.parse(str(name)))
    assert (i.lifetime, i.hop_limit, i.must_be_fresh) == \
        (ti.lifetime, ti.hop_limit, ti.must_be_fresh)
