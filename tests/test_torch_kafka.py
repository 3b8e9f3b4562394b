"""The stream consumer on the port (``spark_fsm_tpu_torch/streaming/
kafka.py`` and ``streaming/consumer.py``), against the reference's
``tests/test_kafka.py``.

Each test of the reference is one test here, parametrised over the two
packages (``_torch_cluster_rig.PKGS``), against the same fake
``poll()``-shaped consumer: the fetch contract's batches, counters and
dead-letter rings must be equal.  The end-to-end case feeds the same
polls through ``KafkaFetch`` and ``PollConsumer`` to each package's
``IncrementalWindowMiner`` (the port's with ``device="cpu"``): the
window's patterns after every poll must equal the other package's and the
copied oracle's.
"""

import pytest

from _torch_cluster_rig import NAMES, PKGS, PortOnCpu, Twins, assert_covers


T = Twins(PKGS)


@pytest.fixture(autouse=True)
def _on_cpu():
    with PortOnCpu():
        yield


def test_covers_the_reference():
    assert_covers(globals(), "test_kafka.py")


class _Rec:
    def __init__(self, value):
        self.value = value


class _OffsetRec(_Rec):
    def __init__(self, value, offset):
        super().__init__(value)
        self.offset = offset


class _FakeConsumer:
    """kafka-python poll() shape: {partition: [records]} per call."""

    def __init__(self, polls):
        self._polls = list(polls)
        self.seen_timeouts = []

    def poll(self, timeout_ms=None):
        self.seen_timeouts.append(timeout_ms)
        return self._polls.pop(0) if self._polls else {}


def _concat(P):
    fake = _FakeConsumer([{"tp0": [_Rec(b"1 -2\n"), _Rec(b"2 -2\n")],
                           "tp1": [_Rec("3 -1 4 -2\n")]}])
    fetch = P.kafka.KafkaFetch(fake, timeout_ms=250)
    rec = {"batch": fetch(), "timeouts": fake.seen_timeouts,
           "stats": fetch.stats}
    assert rec["batch"] == P.spmf.parse_spmf("1 -2\n2 -2\n3 -1 4 -2\n")
    assert rec["timeouts"] == [250]
    assert rec["stats"] == {"polls": 1, "records": 3, "bad_records": 0,
                            "dead_letters": []}
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_poll_concatenates_partitions_in_order(pkg):
    T.held(pkg, _concat)


def _idle(P):
    fetch = P.kafka.KafkaFetch(_FakeConsumer([{}, {"tp0": [_Rec(b"")]}]))
    rec = {"batches": [fetch(), fetch()], "polls": fetch.stats["polls"]}
    assert rec == {"batches": [None, None], "polls": 2}
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_empty_poll_and_empty_records_are_idle(pkg):
    T.held(pkg, _idle)


def _multiline(P):
    fake = _FakeConsumer([{"tp0": [_Rec(b"1 -2\n2 -2\n1 2 -2\n")]}])
    rec = {"batch": P.kafka.KafkaFetch(fake)()}
    assert rec["batch"] == P.spmf.parse_spmf("1 -2\n2 -2\n1 2 -2\n")
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_multiline_record_values(pkg):
    T.held(pkg, _multiline)


def _bad_raise(P):
    fetch = P.kafka.KafkaFetch(_FakeConsumer([{"tp0": [_Rec(b"not spmf")]}]))
    with pytest.raises(ValueError) as exc:
        fetch()
    got = []
    pc = P.consumer.PollConsumer(
        P.kafka.KafkaFetch(_FakeConsumer([{"tp0": [_Rec(b"garbage")]},
                                          {"tp0": [_Rec(b"7 -2\n")]}])),
        got.append, poll_interval_s=0)
    pc.run(max_polls=2)
    rec = {"error": str(exc.value), "errors": pc.stats["errors"],
           "got": got}
    assert rec["errors"] == 1 and got == [P.spmf.parse_spmf("7 -2\n")]
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_bad_record_raise_surfaces_to_supervision(pkg):
    T.held(pkg, _bad_raise)


def _bad_skip(P):
    fake = _FakeConsumer([{"tp0": [_Rec(b"\xff\xfe bad utf8"),
                                   _Rec(b"5 -2\n"), _Rec(b"oops")]}])
    fetch = P.kafka.KafkaFetch(fake, on_bad="skip")
    rec = {"batch": fetch(), "bad": fetch.stats["bad_records"]}
    assert rec == {"batch": P.spmf.parse_spmf("5 -2\n"), "bad": 2}
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_bad_record_skip_counts_and_keeps_good_ones(pkg):
    T.held(pkg, _bad_skip)


def _dead_letters(P):
    big = b"\xff" + b"x" * 500
    fake = _FakeConsumer([{"tp3": [_OffsetRec(big, 41), _Rec(b"5 -2\n"),
                                   _Rec(b"oops")]}])
    fetch = P.kafka.KafkaFetch(fake, on_bad="skip")
    rec = {"batch": fetch(), "ring": fetch.stats["dead_letters"]}
    ring = rec["ring"]
    assert rec["batch"] == P.spmf.parse_spmf("5 -2\n") and len(ring) == 2
    assert ring[0]["partition"] == "tp3" and ring[0]["offset"] == 41
    assert ring[0]["payload"].endswith("...(truncated)")
    assert len(ring[0]["payload"]) < 200
    assert "UnicodeDecodeError" in ring[0]["error"]
    assert ring[1]["offset"] is None and "oops" in ring[1]["payload"]
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_dead_letter_ring_diagnoses_poison_messages(pkg):
    T.held(pkg, _dead_letters)


def _ring_bounded(P):
    fetch = P.kafka.KafkaFetch(_FakeConsumer([{"tp0": [_Rec(b"garbage")]}]))
    with pytest.raises(ValueError):
        fetch()
    raised = fetch.stats["dead_letters"]
    polls = [{"tp0": [_Rec(f"bad {i}".encode())]} for i in range(20)]
    fetch2 = P.kafka.KafkaFetch(_FakeConsumer(polls), on_bad="skip")
    for _ in range(20):
        fetch2()
    ring = fetch2.stats["dead_letters"]
    rec = {"raised": raised, "ring": ring,
           "bad": fetch2.stats["bad_records"]}
    assert len(raised) == 1 and len(ring) == 16 and rec["bad"] == 20
    assert "bad 19" in ring[-1]["payload"] and "bad 4" in ring[0]["payload"]
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_dead_letter_ring_is_bounded_and_recorded_on_raise(pkg):
    T.held(pkg, _ring_bounded)


def _validation(P):
    with pytest.raises(TypeError, match="poll") as e1:
        P.kafka.KafkaFetch(object())
    with pytest.raises(ValueError, match="on_bad") as e2:
        P.kafka.KafkaFetch(_FakeConsumer([]), on_bad="ignore")
    return {"errors": [str(e1.value), str(e2.value)]}


@pytest.mark.parametrize("pkg", NAMES)
def test_constructor_validation(pkg):
    T.held(pkg, _validation)


def _end_to_end(P):
    dbs = [P.synth.synthetic_db(seed=s, n_sequences=40, n_items=8,
                                mean_itemsets=2.5) for s in (1, 2, 3)]
    polls = [{"tp0": [_Rec(P.spmf.format_spmf(db).encode())]} for db in dbs]
    kw = {"device": "cpu"} if P.name == "port" else {}
    wm = P.incremental.IncrementalWindowMiner(0.3, max_batches=2, **kw)
    texts, parities = [], []

    def check(patterns):
        want = P.oracle.mine_spade(wm.window.sequences(), wm.minsup_abs())
        texts.append(P.canonical.patterns_text(patterns))
        parities.append(texts[-1] == P.canonical.patterns_text(want))

    pc = P.consumer.PollConsumer(P.kafka.KafkaFetch(_FakeConsumer(polls)),
                                 wm.push, poll_interval_s=0, on_result=check)
    pc.run(max_polls=4)
    rec = {"batches": pc.stats["batches"], "texts": texts,
           "parities": parities}
    assert rec["batches"] == 3 and parities == [True, True, True]
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_end_to_end_kafka_to_incremental_window_parity(pkg):
    T.held(pkg, _end_to_end)
