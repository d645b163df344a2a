"""The port's lakehouse against the JAX package's, on the CPU.

The JAX package's ten lakehouse cases (`tests/test_lakehouse.py`) run
through both packages, and the port's observations (rows read, versions,
history, file counts, tokens' payloads, audit entries) are held to the
JAX package's. Then the two kept differences, each shown on a scenario
that the JAX package's logic fails:
* `vacuum` keeps every row of the versions it keeps (the JAX package
  deletes the log entry of an append whose file it keeps, and the row
  is gone);
* a commit that finds its version taken by another writer retries at the
  next one (the JAX package overwrites the other writer's acknowledged
  commit), and 16 threads appending at once all read back.
Besides, the audit log records one entry at a time, so entries recorded
from many threads keep one chain. Plus `read_delta`, `scan_delta` and
`DataFrame.write_delta`.
"""

import concurrent.futures as futures
import time

import pytest

import polaroid_tpu as ref
import polaroid_tpu_torch as pt
from polaroid_tpu import lakehouse as RL
from polaroid_tpu_torch import lakehouse as PL


@pytest.fixture(autouse=True, scope="module")
def _fresh_reference_cache():
    """The JAX package's process-wide caches can hand this file's plans
    another frame's results (`tests/test_torch_reference_caches.py`)."""
    from test_torch_reference_caches import fresh_reference_caches
    with fresh_reference_caches():
        yield


# (package, its lakehouse module, the store's keyword arguments, the
# frame keyword arguments)
SIDES = {"ref": (ref, RL, {}, {}),
         "pt": (pt, PL, {"device": "cpu"}, {"device": "cpu"})}


def _frame(side, data):
    pkg, _, _, fkw = SIDES[side]
    return pkg.DataFrame(data, **fkw)


def _store(side, root):
    _, mod, kw, _ = SIDES[side]
    return mod.LakeStore(str(root), **kw)


def case_append_read_versions(side, tmp):
    ls = _store(side, tmp)
    v0 = ls.append("t", _frame(side, {"a": [1, 2]}))
    v1 = ls.append("t", _frame(side, {"a": [3]}))
    out = [(v0, v1), sorted(ls.read("t").to_dict()["a"]),
           sorted(ls.read_version("t", 0).to_dict()["a"]),
           ls.version("t"), ls.tables()]
    assert out == [(0, 1), [1, 2, 3], [1, 2], 1, ["t"]]
    return out


def case_time_travel_timestamp(side, tmp):
    ls = _store(side, tmp)
    ls.append("t", _frame(side, {"a": [1]}))
    ts = time.time()
    time.sleep(0.01)
    ls.append("t", _frame(side, {"a": [2]}))
    out = [ls.read_timestamp("t", ts).to_dict()["a"],
           sorted(ls.read("t").to_dict()["a"])]
    assert out == [[1], [1, 2]]
    return out


def case_overwrite_and_history(side, tmp):
    ls = _store(side, tmp)
    ls.append("t", _frame(side, {"a": [1]}))
    ls.overwrite("t", _frame(side, {"a": [9]}))
    h = ls.history("t")
    out = [ls.read("t").to_dict()["a"], [e["action"] for e in h],
           [e["version"] for e in h], [e["meta"] for e in h]]
    assert out[:2] == [[9], ["append", "overwrite"]]
    return out


def case_delete_where(side, tmp):
    pkg = SIDES[side][0]
    ls = _store(side, tmp)
    ls.append("users", _frame(side, {"id": [1, 2, 3],
                                     "name": ["a", "b", "c"]}))
    v = ls.delete_where("users", pkg.col("id") == 2)
    out = [v, ls.read("users").sort("id").to_dict(),
           sorted(ls.read_version("users", 0).to_dict()["id"]),
           ls.history("users")[-1]["meta"]]
    assert out[1]["id"] == [1, 3] and out[2] == [1, 2, 3]
    return out


def case_compact_and_vacuum(side, tmp):
    ls = _store(side, tmp)
    for i in range(4):
        ls.append("t", _frame(side, {"a": [i]}))
    out = [len(ls._active_files("t"))]
    ls.compact("t", sort_by=["a"])
    out += [len(ls._active_files("t")), ls.read("t").to_dict()["a"],
            ls.history("t")[-1]["meta"]]
    out += [ls.vacuum("t", keep_versions=1), ls.read("t").to_dict()["a"],
            [e["version"] for e in ls.history("t")]]
    assert out[:3] == [4, 1, [0, 1, 2, 3]] and out[4:6] == [4, [0, 1, 2, 3]]
    return out


def case_scan_lazy(side, tmp):
    pkg = SIDES[side][0]
    ls = _store(side, tmp)
    ls.append("t", _frame(side, {"a": [1, 2, 3, 4]}))
    out = sorted(ls.scan("t").filter(pkg.col("a") > 2).collect()
                 .to_dict()["a"])
    assert out == [3, 4]
    return out


def case_auth_roundtrip(side, tmp):
    am = SIDES[side][1].AuthManager()
    am.create_user("alice", "s3cret", role="writer")
    out = [am.authenticate("alice", "wrong")]
    tok = am.authenticate("alice", "s3cret")
    p = am.verify(tok)
    out += [p["sub"], p["role"], am.authorize(tok, "write"),
            am.authorize(tok, "admin_op"), am.verify(tok + "x")]
    am.create_user("bob", "pw", role="reader")
    tb = am.authenticate("bob", "pw")
    out += [am.authorize(tb, "read"), am.authorize(tb, "write")]
    with pytest.raises(SIDES[side][0].ComputeError):
        am.create_user("bob", "again")
    assert out == [None, "alice", "writer", True, False, None, True, False]
    return out


def case_token_expiry(side, tmp):
    am = SIDES[side][1].AuthManager(token_ttl_s=-1)
    am.create_user("x", "y")
    out = am.verify(am.authenticate("x", "y"))
    assert out is None
    return out


def case_audit_chain(side, tmp):
    AuditLog = SIDES[side][1].AuditLog
    al = AuditLog(str(tmp / "audit.jsonl"))
    al.record("alice", "append", "t", {"rows": 3})
    al.record("bob", "read", "t")
    es = al.entries()
    out = [al.verify_chain(), es[1]["prev"] == es[0]["hash"],
           [(e["user"], e["action"], e["table"], e["detail"]) for e in es]]
    lines = (tmp / "audit.jsonl").read_text().splitlines()
    lines[0] = lines[0].replace("alice", "mallory")
    (tmp / "audit.jsonl").write_text("\n".join(lines) + "\n")
    out.append(AuditLog(str(tmp / "audit.jsonl")).verify_chain())
    assert out[:2] == [True, True] and out[3] is False
    return out


def case_lakehouse_end_to_end(side, tmp):
    pkg, mod, kw, _ = SIDES[side]
    lh = mod.Lakehouse(str(tmp), **kw)
    lh.auth.create_user("w", "pw", role="writer")
    lh.auth.create_user("r", "pw", role="reader")
    tw = lh.auth.authenticate("w", "pw")
    tr = lh.auth.authenticate("r", "pw")
    out = [lh.append(tw, "sales", _frame(side, {"v": [1, 2]}))]
    out.append(lh.read(tr, "sales").height)
    with pytest.raises(pkg.ComputeError):
        lh.append(tr, "sales", _frame(side, {"v": [3]}))
    with pytest.raises(pkg.ComputeError):
        lh.read("forged.token", "sales")
    es = lh.audit.entries()
    out += [[e["action"] for e in es], [e["user"] for e in es],
            lh.audit.verify_chain()]
    assert out[2] == ["append", "read", "denied_append", "denied_read"]
    return out


CASES = [case_append_read_versions, case_time_travel_timestamp,
         case_overwrite_and_history, case_delete_where,
         case_compact_and_vacuum, case_scan_lazy, case_auth_roundtrip,
         case_token_expiry, case_audit_chain, case_lakehouse_end_to_end]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__[5:])
def test_case_matches_the_reference(case, tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "pt").mkdir()
    want = case("ref", tmp_path / "ref")
    got = case("pt", tmp_path / "pt")
    assert got == want


def _vacuum_keeps_rows(side, root) -> bool:
    """Two appends (2 rows, then 1), vacuum keeping the last version:
    whether the table still reads its 3 rows."""
    ls = _store(side, root)
    ls.append("t", _frame(side, {"a": [1, 2]}))
    ls.append("t", _frame(side, {"a": [3]}))
    removed = ls.vacuum("t", keep_versions=1)
    assert removed == 0
    return sorted(ls.read("t").to_dict()["a"]) == [1, 2, 3]


def test_vacuum_keeps_every_row(tmp_path):
    assert _vacuum_keeps_rows("pt", tmp_path / "pt")
    # the JAX package's vacuum reads back one row of the three
    assert not _vacuum_keeps_rows("ref", tmp_path / "ref")


def test_vacuum_removes_only_logged_files(tmp_path):
    """A data file that no log entry names (an append between writing
    its file and committing) survives a vacuum; the replaced ones go."""
    ls = _store("pt", tmp_path)
    ls.append("t", _frame("pt", {"a": [1]}))
    ls.overwrite("t", _frame("pt", {"a": [2]}))
    pending = ls._new_file("t", _frame("pt", {"a": [3]}))
    assert ls.vacuum("t", keep_versions=1) == 1
    assert (tmp_path / "t" / pending).exists()
    assert [e["version"] for e in ls.history("t")] == [1]
    assert ls.read("t").to_dict()["a"] == [2]


def _raced_append_reads_back(side, root) -> bool:
    """A writer lists the versions; before it commits, another writer
    commits the version it is about to take. Whether both appends read
    back with distinct versions."""
    _, mod, kw, _ = SIDES[side]
    other = _store(side, root)
    acked = []

    class Racing(mod.LakeStore):
        raced = False

        def _versions(self, table):
            out = super()._versions(table)
            if not Racing.raced:
                Racing.raced = True
                acked.append(other.append("t", _frame(side, {"a": [1]})))
            return out
    acked.append(Racing(str(root), **kw).append("t",
                                                _frame(side, {"a": [2]})))
    return sorted(acked) == [0, 1] and \
        sorted(other.read("t").to_dict()["a"]) == [1, 2]


def test_a_commit_never_takes_a_taken_version(tmp_path):
    assert _raced_append_reads_back("pt", tmp_path / "pt")
    # the JAX package's commit overwrites the other writer's version 0
    assert not _raced_append_reads_back("ref", tmp_path / "ref")


def test_raced_rewrite_redoes_its_work(tmp_path):
    """A delete_where whose version another append takes first reads the
    new snapshot and deletes from it: the append's row stays."""
    ls = _store("pt", tmp_path)
    ls.append("t", _frame("pt", {"a": [1, 2]}))
    other = _store("pt", tmp_path)

    class Racing(PL.LakeStore):
        raced = False

        def read_version(self, table, version):
            out = super().read_version(table, version)
            if not Racing.raced:
                Racing.raced = True
                other.append("t", _frame("pt", {"a": [2, 3]}))
            return out
    v = Racing(str(tmp_path), device="cpu").delete_where("t", pt.col("a") == 1)
    assert v == 2
    assert sorted(ls.read("t").to_dict()["a"]) == [2, 2, 3]
    assert [e["action"] for e in ls.history("t")] == [
        "append", "append", "delete_where"]
    assert len(list(tmp_path.joinpath("t").glob("part-*.parquet"))) == 3


def test_sixteen_concurrent_appends_all_read_back(tmp_path):
    ls = _store("pt", tmp_path)

    def one(i):
        return i, ls.append("t", _frame("pt", {"a": [i]}))
    with futures.ThreadPoolExecutor(16) as ex:
        acked = list(ex.map(one, range(16)))
    assert sorted(v for _, v in acked) == list(range(16))
    assert sorted(ls.read("t").to_dict()["a"]) == list(range(16))
    hist = {e["version"]: e for e in ls.history("t")}
    for i, v in acked:
        assert hist[v]["action"] == "append"


def test_delta_functions_round_trip(tmp_path):
    df = pt.DataFrame({"a": [3, 1, 2], "s": ["x", None, "z"]}, device="cpu")
    df.write_delta(tmp_path)
    with pytest.raises(pt.InvalidOperationError):
        df.write_delta(tmp_path)
    df.write_delta(tmp_path, mode="ignore")
    df.write_delta(tmp_path, mode="append")
    back = pt.read_delta(tmp_path, device="cpu")
    assert back.device.type == "cpu" and back.height == 6
    assert pt.read_delta(tmp_path, version=0, device="cpu").to_dict() == \
        df.to_dict()
    lz = pt.scan_delta(tmp_path, device="cpu").filter(pt.col("a") > 1)
    assert sorted(lz.collect().to_dict()["a"]) == [2, 2, 3, 3]
    df.write_delta(tmp_path, mode="overwrite")
    assert pt.read_delta(tmp_path, device="cpu").to_dict() == df.to_dict()
    with pytest.raises(pt.InvalidOperationError):
        df.write_delta(tmp_path, mode="merge")
    # the JAX package reads what the port wrote
    assert ref.read_delta(str(tmp_path)).to_dict() == df.to_dict()


def test_concurrent_audit_records_keep_one_chain(tmp_path):
    """Appends through a `Lakehouse` from many threads record their audit
    entries one at a time: the chain verifies and holds every entry."""
    al = PL.AuditLog(str(tmp_path / "audit.jsonl"))

    def many(i):
        for j in range(20):
            al.record(f"u{i}", "append", "t", {"j": j})
    with futures.ThreadPoolExecutor(16) as ex:
        list(ex.map(many, range(16)))
    assert len(al.entries()) == 320
    assert al.verify_chain()
    assert PL.AuditLog(str(tmp_path / "audit.jsonl")).verify_chain()
