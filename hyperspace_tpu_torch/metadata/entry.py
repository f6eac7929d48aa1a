"""Index log entry — the versioned JSON metadata document.

Reference: ``index/IndexLogEntry.scala`` (703 LoC):

* ``FileInfo`` (:308-332) — (name, size, mtime, stable id)
* ``Directory`` (:123-303) — recursive file tree with ``merge``
* ``Content`` (:40-113) — a rooted ``Directory`` + helpers
* ``Hdfs``/``Update`` (:351-366) — source snapshot + quick-refresh delta
* ``Relation``/``SparkPlan``/``Source`` (:379-397) — provider-agnostic
  description of the indexed source
* ``LogicalPlanFingerprint``/``Signature`` (:335-343)
* ``IndexLogEntry`` (:408-590) — ties it all together + per-plan tag cache
* ``FileIdTracker`` (:627-703) — stable numeric id per (path,size,mtime)

The JSON layout is a faithful semantic port (field names are snake_case and
the Spark-plan string is replaced by our own relation description); the
polymorphic ``derivedDataset`` uses a ``"type"`` discriminator resolved via
the index registry (:mod:`hyperspace_tpu_torch.indexes.registry`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from hyperspace_tpu_torch.constants import States
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.utils import paths as path_utils

LOG_VERSION = "0.1"

UNKNOWN_FILE_ID = -1


# ---------------------------------------------------------------------------
# FileInfo / Directory / Content
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FileInfo:
    """A leaf file: name (no directory), size, mtime (ms), stable id.

    Reference: IndexLogEntry.scala:308-332. Equality/hash ignore ``id`` as
    in the reference (id is assigned metadata, not identity).
    """

    name: str
    size: int
    modified_time: int
    id: int = UNKNOWN_FILE_ID

    def __eq__(self, other):
        return (
            isinstance(other, FileInfo)
            and self.name == other.name
            and self.size == other.size
            and self.modified_time == other.modified_time
        )

    def __hash__(self):
        return hash((self.name, self.size, self.modified_time))

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "size": self.size,
            "modifiedTime": self.modified_time,
            "id": self.id,
        }

    @staticmethod
    def from_dict(d: dict) -> "FileInfo":
        return FileInfo(d["name"], d["size"], d["modifiedTime"], d.get("id", -1))


@dataclasses.dataclass
class Directory:
    """Recursive directory node (IndexLogEntry.scala:123-303)."""

    name: str
    files: List[FileInfo] = dataclasses.field(default_factory=list)
    subdirs: List["Directory"] = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "files": [f.to_dict() for f in self.files],
            "subDirs": [d.to_dict() for d in self.subdirs],
        }

    @staticmethod
    def from_dict(d: dict) -> "Directory":
        return Directory(
            d["name"],
            [FileInfo.from_dict(f) for f in d.get("files", [])],
            [Directory.from_dict(s) for s in d.get("subDirs", [])],
        )

    # -- construction -------------------------------------------------------

    @staticmethod
    def _split_path(path: str) -> List[str]:
        """Directory components of ``path`` (excluding the file name).

        Scheme-qualified paths keep ``scheme://authority`` as the first
        component so object-store URIs round-trip unmangled.
        """
        if "://" in path:
            scheme, rest = path.split("://", 1)
            comps = [p for p in rest.split("/") if p]
            if not comps:
                return [scheme + "://"]
            return [f"{scheme}://{comps[0]}"] + comps[1:-1]
        return [p for p in path.split("/") if p][:-1]

    @staticmethod
    def from_leaf_files(files: Iterable[Tuple[str, FileInfo]]) -> "Directory":
        """Build the minimal tree containing ``(absolute_path, FileInfo)``.

        Mirrors ``Directory.fromLeafFiles`` (IndexLogEntry.scala:214-303):
        the root is the filesystem root ("/"), each path component becomes a
        nested Directory. ``scheme://authority`` prefixes become first-level
        nodes under the root.
        """
        root = Directory("/")
        for path, info in files:
            parts = Directory._split_path(path)
            node = root
            for part in parts:
                nxt = next((s for s in node.subdirs if s.name == part), None)
                if nxt is None:
                    nxt = Directory(part)
                    node.subdirs.append(nxt)
                node = nxt
            node.files.append(info)
        root._sort()
        return root

    def _sort(self) -> None:
        self.files.sort(key=lambda f: f.name)
        self.subdirs.sort(key=lambda d: d.name)
        for s in self.subdirs:
            s._sort()

    def merge(self, other: "Directory") -> "Directory":
        """Merge two trees rooted at the same name (IndexLogEntry.scala:149-171).

        Files are unioned (by (name,size,mtime) identity); ids from ``self``
        win on duplicates.
        """
        if self.name != other.name:
            raise HyperspaceException(
                f"Merging directories with different names: "
                f"{self.name!r} vs {other.name!r}"
            )
        seen = {}
        for f in list(self.files) + list(other.files):
            seen.setdefault((f.name, f.size, f.modified_time), f)
        merged_files = sorted(seen.values(), key=lambda f: f.name)
        by_name = {d.name: d for d in self.subdirs}
        merged_subdirs: List[Directory] = []
        other_names = set()
        for od in other.subdirs:
            other_names.add(od.name)
            if od.name in by_name:
                merged_subdirs.append(by_name[od.name].merge(od))
            else:
                merged_subdirs.append(od)
        for sd in self.subdirs:
            if sd.name not in other_names:
                merged_subdirs.append(sd)
        merged_subdirs.sort(key=lambda d: d.name)
        return Directory(self.name, merged_files, merged_subdirs)

    # -- traversal ----------------------------------------------------------

    def leaf_files(self, prefix: str = "") -> List[Tuple[str, FileInfo]]:
        if self.name == "/":
            base = prefix
        elif "://" in self.name:
            base = self.name  # scheme://authority node: no leading separator
        else:
            base = f"{prefix}/{self.name}"
        out = [(f"{base}/{f.name}", f) for f in self.files]
        for d in self.subdirs:
            out.extend(d.leaf_files(base))
        return out


@dataclasses.dataclass
class Content:
    """A rooted directory tree = the file set of an index version or source.

    Reference: IndexLogEntry.scala:40-113.
    """

    root: Directory

    def to_dict(self) -> dict:
        return {"root": self.root.to_dict()}

    @staticmethod
    def from_dict(d: dict) -> "Content":
        return Content(Directory.from_dict(d["root"]))

    @staticmethod
    def from_leaf_files(
        files: Iterable[Tuple[str, int, int]],
        file_id_tracker: Optional["FileIdTracker"] = None,
    ) -> "Content":
        """files = (absolute_path, size, mtime_ms); ids via tracker if given."""
        pairs = []
        for p, size, mtime in files:
            p = p.replace("\\", "/")
            fid = (
                file_id_tracker.add_file(p, size, mtime)
                if file_id_tracker is not None
                else UNKNOWN_FILE_ID
            )
            pairs.append((p, FileInfo(p.rsplit("/", 1)[-1], size, mtime, fid)))
        return Content(Directory.from_leaf_files(pairs))

    @staticmethod
    def from_directory_scan(
        directory: str, file_id_tracker: Optional["FileIdTracker"] = None
    ) -> "Content":
        """Recursive listing of a real directory (Content.fromDirectory,
        IndexLogEntry.scala:86-96)."""
        from hyperspace_tpu_torch.utils import files as file_utils

        listed = [
            t
            for t in file_utils.list_leaf_files(directory)
            if path_utils.is_data_path(t[0])
        ]
        return Content.from_leaf_files(listed, file_id_tracker)

    @property
    def files(self) -> List[str]:
        return [p for p, _ in self.root.leaf_files()]

    @property
    def file_infos(self) -> List[Tuple[str, FileInfo]]:
        return self.root.leaf_files()

    @property
    def size_in_bytes(self) -> int:
        return sum(f.size for _, f in self.root.leaf_files())

    def merge(self, other: "Content") -> "Content":
        return Content(self.root.merge(other.root))


# ---------------------------------------------------------------------------
# Source description
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Update:
    """Quick-refresh delta recorded in metadata (IndexLogEntry.scala:351)."""

    appended_files: Optional[Content] = None
    deleted_files: Optional[Content] = None

    def to_dict(self) -> dict:
        return {
            "appendedFiles": self.appended_files.to_dict()
            if self.appended_files
            else None,
            "deletedFiles": self.deleted_files.to_dict()
            if self.deleted_files
            else None,
        }

    @staticmethod
    def from_dict(d: Optional[dict]) -> Optional["Update"]:
        if not d:
            return None
        return Update(
            Content.from_dict(d["appendedFiles"]) if d.get("appendedFiles") else None,
            Content.from_dict(d["deletedFiles"]) if d.get("deletedFiles") else None,
        )


@dataclasses.dataclass
class Relation:
    """Description of one indexed source relation.

    Reference: IndexLogEntry.scala:379-384 (rootPaths, Hdfs data w/ content
    + update, dataSchemaJson, fileFormat, options).
    """

    root_paths: List[str]
    content: Content                      # snapshot of source files at build
    schema_json: str                      # serialized arrow schema (JSON)
    file_format: str
    options: Dict[str, str] = dataclasses.field(default_factory=dict)
    update: Optional[Update] = None       # quick-refresh delta

    def to_dict(self) -> dict:
        return {
            "rootPaths": self.root_paths,
            "data": {
                "properties": {
                    "content": self.content.to_dict(),
                    "update": self.update.to_dict() if self.update else None,
                }
            },
            "dataSchemaJson": self.schema_json,
            "fileFormat": self.file_format,
            "options": dict(self.options),
        }

    @staticmethod
    def from_dict(d: dict) -> "Relation":
        props = d["data"]["properties"]
        return Relation(
            list(d["rootPaths"]),
            Content.from_dict(props["content"]),
            d["dataSchemaJson"],
            d["fileFormat"],
            dict(d.get("options", {})),
            Update.from_dict(props.get("update")),
        )


@dataclasses.dataclass
class SourcePlan:
    """Provider-agnostic stand-in for the reference's serialized SparkPlan
    (IndexLogEntry.scala:387-397): the list of leaf relations plus the
    source-provider name that produced them."""

    relations: List[Relation]
    provider: str = "default"

    def to_dict(self) -> dict:
        return {
            "relations": [r.to_dict() for r in self.relations],
            "provider": self.provider,
        }

    @staticmethod
    def from_dict(d: dict) -> "SourcePlan":
        return SourcePlan(
            [Relation.from_dict(r) for r in d["relations"]],
            d.get("provider", "default"),
        )


@dataclasses.dataclass(frozen=True)
class Signature:
    """(provider, value) plan fingerprint component (IndexLogEntry.scala:335)."""

    provider: str
    value: str

    def to_dict(self) -> dict:
        return {"provider": self.provider, "value": self.value}

    @staticmethod
    def from_dict(d: dict) -> "Signature":
        return Signature(d["provider"], d["value"])


@dataclasses.dataclass
class LogicalPlanFingerprint:
    """Fingerprint of the source logical plan (IndexLogEntry.scala:338-343)."""

    signatures: List[Signature]
    kind: str = "LogicalPlan"

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "properties": {"signatures": [s.to_dict() for s in self.signatures]},
        }

    @staticmethod
    def from_dict(d: dict) -> "LogicalPlanFingerprint":
        return LogicalPlanFingerprint(
            [Signature.from_dict(s) for s in d["properties"]["signatures"]],
            d.get("kind", "LogicalPlan"),
        )


@dataclasses.dataclass
class Source:
    plan: SourcePlan

    def to_dict(self) -> dict:
        return {"plan": self.plan.to_dict()}

    @staticmethod
    def from_dict(d: dict) -> "Source":
        return Source(SourcePlan.from_dict(d["plan"]))


# ---------------------------------------------------------------------------
# FileIdTracker
# ---------------------------------------------------------------------------


class FileIdTracker:
    """Stable numeric id per (path, size, mtime); basis of the lineage column.

    Reference: IndexLogEntry.scala:627-703. Ids never change for a given
    key; new keys get ``max_id + 1``.
    """

    def __init__(self):
        self._ids: Dict[Tuple[str, int, int], int] = {}
        self._max_id = UNKNOWN_FILE_ID

    @property
    def max_id(self) -> int:
        return self._max_id

    def add_file(self, path: str, size: int, mtime: int) -> int:
        key = (path, size, mtime)
        fid = self._ids.get(key)
        if fid is None:
            self._max_id += 1
            fid = self._max_id
            self._ids[key] = fid
        return fid

    def add_file_info(self, path: str, info: FileInfo) -> None:
        """Seed from a previous log entry's recorded ids
        (FileIdTracker.addFileInfo:657)."""
        if info.id == UNKNOWN_FILE_ID:
            raise HyperspaceException(f"File {path} has no id recorded")
        key = (path, info.size, info.modified_time)
        existing = self._ids.get(key)
        if existing is not None and existing != info.id:
            raise HyperspaceException(
                f"Conflicting ids for {key}: {existing} vs {info.id}"
            )
        self._ids[key] = info.id
        self._max_id = max(self._max_id, info.id)

# ---------------------------------------------------------------------------
# LogEntry / IndexLogEntry
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LogEntry:
    """Abstract base (LogEntry.scala:22-30): version, id, state, timestamp."""

    version: str = LOG_VERSION
    id: int = 0
    state: str = States.DOESNOTEXIST
    timestamp: int = dataclasses.field(
        default_factory=lambda: int(time.time() * 1000)
    )


class IndexLogEntry(LogEntry):
    """The full metadata document for one index version.

    Reference: IndexLogEntry.scala:408-590. ``derived_dataset`` is the
    polymorphic Index object (covering / z-order / data-skipping).
    """

    def __init__(
        self,
        name: str,
        derived_dataset,                    # indexes.base.Index
        content: Content,
        source: Source,
        fingerprint: LogicalPlanFingerprint,
        properties: Optional[Dict[str, str]] = None,
        state: str = States.DOESNOTEXIST,
        id: int = 0,
        timestamp: Optional[int] = None,
    ):
        super().__init__(
            LOG_VERSION,
            id,
            state,
            timestamp if timestamp is not None else int(time.time() * 1000),
        )
        self.name = name
        self.derived_dataset = derived_dataset
        self.content = content
        self.source = source
        self.fingerprint = fingerprint
        self.properties: Dict[str, str] = dict(properties or {})
        # Per-plan mutable tag cache (IndexLogEntry.scala:537-589). Keyed by
        # (plan_key, tag_name); never serialized.
        self._tags: Dict[Tuple[Any, str], Any] = {}

    # -- identity -----------------------------------------------------------
    def __eq__(self, other):
        return (
            isinstance(other, IndexLogEntry)
            and self.name == other.name
            and self.derived_dataset == other.derived_dataset
            and self.content.to_dict() == other.content.to_dict()
            and self.source.to_dict() == other.source.to_dict()
            and self.fingerprint.to_dict() == other.fingerprint.to_dict()
            and self.state == other.state
        )

    def __hash__(self):
        return hash((self.name, self.state, self.id))

    def __repr__(self):
        return (
            f"IndexLogEntry(name={self.name!r}, state={self.state}, id={self.id})"
        )

    # -- convenience --------------------------------------------------------
    @property
    def relations(self) -> List[Relation]:
        return self.source.plan.relations

    @property
    def relation(self) -> Relation:
        # Reference supports exactly one relation per index (CreateAction
        # validation); same here.
        return self.relations[0]

    @property
    def source_files_size_in_bytes(self) -> int:
        return self.relation.content.size_in_bytes

    @property
    def has_source_update(self) -> bool:
        """True when a quick refresh recorded a pending source delta
        (IndexLogEntry.hasSourceUpdate): the fingerprint matches the newer
        source but the index DATA still reflects the original snapshot, so
        serving requires Hybrid Scan compensation."""
        u = self.relation.update
        return u is not None and (
            u.appended_files is not None or u.deleted_files is not None
        )

    def file_id_tracker(self) -> FileIdTracker:
        """Rebuild the tracker from recorded source + index file ids."""
        t = FileIdTracker()
        for p, info in self.relation.content.file_infos:
            if info.id != UNKNOWN_FILE_ID:
                t.add_file_info(p, info)
        if self.relation.update and self.relation.update.appended_files:
            for p, info in self.relation.update.appended_files.file_infos:
                if info.id != UNKNOWN_FILE_ID:
                    t.add_file_info(p, info)
        return t

    def with_state(self, state: str) -> "IndexLogEntry":
        out = self.copy()
        out.state = state
        return out

    def copy(self) -> "IndexLogEntry":
        return IndexLogEntry.from_dict(self.to_dict())

    # -- tags (IndexLogEntry.scala:537-589) ---------------------------------
    def set_tag(self, plan_key: Any, tag: str, value: Any) -> None:
        self._tags[(plan_key, tag)] = value

    def get_tag(self, plan_key: Any, tag: str) -> Optional[Any]:
        return self._tags.get((plan_key, tag))

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "version": self.version,
            "id": self.id,
            "state": self.state,
            "timestamp": self.timestamp,
            "name": self.name,
            "derivedDataset": self.derived_dataset.to_dict(),
            "content": self.content.to_dict(),
            "source": self.source.to_dict(),
            "fingerprint": self.fingerprint.to_dict(),
            "properties": dict(self.properties),
        }

    @staticmethod
    def from_dict(d: dict) -> "IndexLogEntry":
        from hyperspace_tpu_torch.indexes.registry import index_from_dict

        entry = IndexLogEntry(
            name=d["name"],
            derived_dataset=index_from_dict(d["derivedDataset"]),
            content=Content.from_dict(d["content"]),
            source=Source.from_dict(d["source"]),
            fingerprint=LogicalPlanFingerprint.from_dict(d["fingerprint"]),
            properties=d.get("properties", {}),
            state=d["state"],
            id=d["id"],
            timestamp=d.get("timestamp"),
        )
        return entry
