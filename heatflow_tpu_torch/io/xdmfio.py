"""XDMF + HDF5 time-series output and extraction.

Replaces dolfinx.io.XDMFFile (ref run_no_diamond.py:364-374,568-569) and the
meshio-based point extraction (ref io_utilities/xdmf_extract.py). Heavy data
(geometry, topology, per-step nodal fields) lives in an HDF5 sidecar; the
.xdmf file is the XML index — readable by ParaView and by
:func:`read_xdmf_timeseries`. ``h5py`` is imported at first use (no driver
default writes XDMF); without it that use raises ``ImportError``.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("XDMF output needs the h5py package") from e
    return h5py

_TOPO_TYPE = {3: "Triangle", 2: "Polyline"}


class XDMFTimeSeriesWriter:
    """Write a mesh once, then one nodal scalar field per time step."""

    def __init__(self, path: str, nodes: np.ndarray, cells: np.ndarray,
                 field_name: str = "Temperature (K)"):
        self.path = path
        self.h5path = os.path.splitext(path)[0] + ".h5"
        self.field_name = field_name
        self.nodes = np.asarray(nodes, dtype=np.float64)
        self.cells = np.asarray(cells, dtype=np.int64)
        self.times: list[float] = []
        self._h5 = _h5py().File(self.h5path, "w")
        # pad 2D coords to 3D XYZ for visualization tools
        xyz = np.zeros((len(self.nodes), 3))
        xyz[:, :self.nodes.shape[1]] = self.nodes
        self._h5.create_dataset("mesh/geometry", data=xyz)
        self._h5.create_dataset("mesh/topology", data=self.cells)
        self._steps = self._h5.create_group("fields")

    def write(self, field: np.ndarray, t: float) -> None:
        idx = len(self.times)
        self._steps.create_dataset(f"step_{idx:06d}",
                                   data=np.asarray(field, np.float64).ravel())
        self.times.append(float(t))

    def close(self) -> None:
        self._h5.create_dataset("times", data=np.asarray(self.times))
        self._h5.close()
        self._write_xml()

    # ------------------------------------------------------------------
    def _write_xml(self) -> None:
        h5rel = os.path.basename(self.h5path)
        npts, ncell = len(self.nodes), len(self.cells)
        nv = self.cells.shape[1]
        xdmf = ET.Element("Xdmf", Version="3.0")
        dom = ET.SubElement(xdmf, "Domain")
        grid_t = ET.SubElement(dom, "Grid", Name="TimeSeries",
                               GridType="Collection", CollectionType="Temporal")
        for idx, t in enumerate(self.times):
            g = ET.SubElement(grid_t, "Grid", Name=f"step_{idx}",
                              GridType="Uniform")
            ET.SubElement(g, "Time", Value=repr(t))
            topo = ET.SubElement(g, "Topology",
                                 TopologyType=_TOPO_TYPE[nv],
                                 NumberOfElements=str(ncell))
            d = ET.SubElement(topo, "DataItem",
                              Dimensions=f"{ncell} {nv}", Format="HDF",
                              NumberType="Int")
            d.text = f"{h5rel}:/mesh/topology"
            geo = ET.SubElement(g, "Geometry", GeometryType="XYZ")
            d = ET.SubElement(geo, "DataItem", Dimensions=f"{npts} 3",
                              Format="HDF")
            d.text = f"{h5rel}:/mesh/geometry"
            att = ET.SubElement(g, "Attribute", Name=self.field_name,
                                AttributeType="Scalar", Center="Node")
            d = ET.SubElement(att, "DataItem", Dimensions=str(npts),
                              Format="HDF")
            d.text = f"{h5rel}:/fields/step_{idx:06d}"
        ET.ElementTree(xdmf).write(self.path, xml_declaration=True)


def read_xdmf_timeseries(path: str, field_name: str | None = None):
    """Return (times (S,), nodes (N,2), cells, fields (S,N)).

    XML-driven: the .xdmf index is parsed and every DataItem resolved
    (Format='HDF' sidecar references or inline Format='XML' payloads), so
    files written by this module, by dolfinx.io.XDMFFile, or by meshio's
    TimeSeriesWriter all read through the same code path (the reference's
    files are dolfinx/meshio-written, ref io_utilities/xdmf_extract.py:31-56).
    ``field_name`` selects among multiple attributes (default: the first).
    """
    base = os.path.dirname(os.path.abspath(path))
    root = ET.parse(path).getroot()
    h5py = _h5py()
    h5cache: dict = {}

    def h5file(fname):
        if fname not in h5cache:
            h5cache[fname] = h5py.File(os.path.join(base, fname), "r")
        return h5cache[fname]

    def read_item(el):
        fmt = el.get("Format", "XML")
        dims = [int(d) for d in el.get("Dimensions", "").split()]
        if fmt.upper() in ("HDF", "HDF5"):
            fname, hpath = el.text.strip().split(":", 1)
            # sidecar path is relative to the .xdmf (subdirs legal); fall
            # back to the basename for absolute paths from other machines
            if not os.path.exists(os.path.join(base, fname)):
                fname = os.path.basename(fname)
            arr = h5file(fname)[hpath][()]
        elif fmt.upper() == "XML":
            arr = np.array(el.text.split(), dtype=np.float64)
            if el.get("NumberType", "Float") in ("Int", "UInt"):
                arr = arr.astype(np.int64)
        else:
            raise ValueError(f"unsupported XDMF DataItem format {fmt!r}")
        if dims:
            arr = arr.reshape(dims)
        return arr

    def strip_ns(tag):
        return tag.rsplit("}", 1)[-1]

    def children(el, name):
        """Direct children by local tag name (namespace-agnostic, matching
        the strip_ns element scan)."""
        return [c for c in el if strip_ns(c.tag) == name]

    def child(el, name):
        cs = children(el, name)
        return cs[0] if cs else None

    try:
        geo_el = topo_el = None
        times, fields = [], []
        for el in root.iter():
            if strip_ns(el.tag) == "Geometry" and geo_el is None:
                geo_el = child(el, "DataItem")
            elif strip_ns(el.tag) == "Topology" and topo_el is None:
                topo_el = child(el, "DataItem")
        if geo_el is None or topo_el is None:
            raise ValueError(f"{path}: no Geometry/Topology DataItem found")
        nodes = np.asarray(read_item(geo_el), dtype=np.float64)[:, :2]
        cells = np.asarray(read_item(topo_el)).astype(np.int64)

        for g in root.iter():
            if strip_ns(g.tag) != "Grid":
                continue
            t_el = child(g, "Time")
            if t_el is None:
                continue
            atts = children(g, "Attribute")
            if field_name is not None:
                atts = [a for a in atts if a.get("Name") == field_name] \
                    or atts  # tolerate name mismatches like the reference
            if not atts:
                continue
            times.append(float(t_el.get("Value")))
            fields.append(np.asarray(
                read_item(child(atts[0], "DataItem")), np.float64).ravel())
    finally:
        for f in h5cache.values():
            f.close()

    if not times:
        raise ValueError(f"{path}: no timesteps found")
    order = np.argsort(times)
    return (np.asarray(times)[order], nodes, cells,
            np.stack(fields)[order])


def extract_point_timeseries_xdmf(xdmf_path: str, function_name: str,
                                  query_points, method: str = "nearest"):
    """Post-hoc extraction of a nodal field at query points.

    Same contract as the reference utility (io_utilities/xdmf_extract.py:6-60):
    returns (times (S,), data (n_points, S)); 'nearest' uses nearest vertex,
    'linear' barycentric interpolation.
    """
    times, nodes, _cells, fields = read_xdmf_timeseries(
        xdmf_path, field_name=function_name)
    qp = np.asarray(query_points, dtype=float)
    if method == "nearest":
        d2 = ((nodes[None, :, :] - qp[:, None, :]) ** 2).sum(-1)
        idx = d2.argmin(axis=1)
        data = fields[:, idx].T
    elif method == "linear":
        from scipy.interpolate import griddata
        data = np.stack([
            griddata(nodes, fields[s], qp, method="linear")
            for s in range(len(times))], axis=1)
    else:
        raise ValueError(f"unknown method {method!r}")
    order = np.argsort(times)
    return times[order], data[:, order]
