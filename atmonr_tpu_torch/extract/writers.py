"""Extraction output writers: netCDF-4 (written with h5py) and OpenVDB,
with a ``.npy`` pair where OpenVDB is missing.

A copy of the JAX package's ``extract/writers.py``: the same datasets,
dimension scales, attributes and fill values. netCDF-4 files are HDF5 with
netCDF dimension scales, so netCDF tools read them. h5py and OpenVDB are
imported only when a file is written, so the module imports where they are
missing.
"""

from __future__ import annotations

import warnings
from pathlib import Path

import numpy as np

FILL = np.float32(-32767.0)


def _nc_file(path: Path):
    if path.suffix != ".nc":
        raise ValueError(f"{path}: a netCDF extract needs the .nc suffix")
    import h5py

    f = h5py.File(path, "w")
    # netCDF-4 signature attribute so readers treat this as netCDF
    f.attrs["Conventions"] = "CF-1.8"
    return f


def _dim(f, name: str, size: int):
    d = f.create_dataset(name, data=np.arange(size, dtype=np.float64))
    d.make_scale(name)
    return d


def _var(f, name, dtype, dims, fill_value=FILL):
    shape = tuple(d.shape[0] for d in dims)
    v = f.create_dataset(name, shape=shape, dtype=dtype, fillvalue=fill_value)
    for i, d in enumerate(dims):
        v.dims[i].attach_scale(d)
    v.attrs["_FillValue"] = np.asarray(fill_value, dtype)
    return v


def _scene_attrs(f, ds) -> None:
    f.attrs["input_l1b_product_name"] = ds.granule.product_name
    f.attrs["neural_rendering_scene_scale"] = ds.scale
    f.attrs["neural_rendering_scene_offset_x"] = float(ds.offset[0])
    f.attrs["neural_rendering_scene_offset_y"] = float(ds.offset[1])
    f.attrs["neural_rendering_scene_offset_z"] = float(ds.offset[2])


def _wgs84_vars(f, xyz: np.ndarray, dims) -> None:
    for i, axis in enumerate("xyz"):
        v = _var(f, f"{axis}_wgs84", np.float32, dims)
        v.attrs.update(
            units="meters",
            long_name=f"{axis.upper()} coordinate in WGS-84 cartesian (EPSG:4978)",
        )
        v[:] = xyz[..., i]


def extract_to_netcdf(output_filepath: Path, extract_dataset, sigma) -> None:
    """Write an L1C or voxelgrid extract to netCDF: latitude, longitude and
    surface height per column, the altitude ladder, the extinction
    coefficient (along, across, vertical, bands) and the ECEF points."""
    output_filepath = Path(output_filepath)
    ds = extract_dataset.dataset
    sigma = np.asarray(sigma)
    num_bands = sigma.shape[-1]
    shp = extract_dataset.shp
    na = extract_dataset.sample_alt.shape[0]
    sigma = sigma.reshape(shp[0], shp[1], na, num_bands)

    f = _nc_file(output_filepath)
    try:
        f.attrs["title"] = "PACE HARP2 Neural Rendering Volumetric Data"
        _scene_attrs(f, ds)

        d_along = _dim(f, "bins_along_track", shp[0])
        d_across = _dim(f, "bins_across_track", shp[1])
        d_vert = _dim(f, "bins_vertical", na)
        d_bands = _dim(f, "number_of_bands", num_bands)

        lat = _var(f, "latitude", np.float32, (d_along, d_across))
        lat.attrs.update(
            long_name="Latitude of bin locations",
            units="degrees_north",
            valid_min=-90.0,
            valid_max=90.0,
        )
        lat[:] = extract_dataset.lat[..., 0]
        lon = _var(f, "longitude", np.float32, (d_along, d_across))
        lon.attrs.update(
            long_name="Longitude of bin locations",
            units="degrees_east",
            valid_min=-180.0,
            valid_max=180.0,
        )
        lon[:] = extract_dataset.lon[..., 0]
        height = _var(f, "height", np.float32, (d_along, d_across))
        height.attrs.update(
            long_name="Altitude at bin locations",
            units="meters",
            valid_min=-1000.0,
            valid_max=10000.0,
        )
        height[:] = extract_dataset.height

        alt = _var(f, "altitude", np.float32, (d_vert,))
        alt.attrs.update(units="meters", long_name="Altitude above surface")
        alt[:] = extract_dataset.sample_alt

        nc_sigma = _var(
            f, "extinction_coefficient", np.float32, (d_along, d_across, d_vert, d_bands)
        )
        nc_sigma.attrs.update(units="m^-1", long_name="Extinction coefficient", valid_min=0.0)
        nc_sigma[:] = sigma

        xyz = extract_dataset.xyz.reshape(shp[0], shp[1], na, 3)
        _wgs84_vars(f, xyz, (d_along, d_across, d_vert))
    finally:
        f.close()


def earthcare_to_netcdf(output_filepath: Path, extract_dataset, sigma) -> None:
    """Write an extract at EarthCARE ATLID level 2A coordinates to netCDF,
    carrying the track's units, names and comments."""
    output_filepath = Path(output_filepath)
    ds = extract_dataset.dataset
    sigma = np.asarray(sigma)
    num_bands = sigma.shape[-1]
    shp = extract_dataset.shp
    sigma = sigma.reshape(shp[0], shp[1], num_bands)

    f = _nc_file(output_filepath)
    try:
        f.attrs["title"] = (
            "PACE HARP2 Neural Rendering Volumetric Data in EarthCARE ATLID "
            "level 2A coordinates."
        )
        _scene_attrs(f, ds)
        if isinstance(extract_dataset.earthcare_range, list):
            f.attrs["earthcare_start_idx"] = extract_dataset.earthcare_range[0]
            f.attrs["earthcare_end_idx"] = extract_dataset.earthcare_range[1]
        f.attrs["ray_origin_height"] = ds.config["ray_origin_height"]

        d_along = _dim(f, "along_track", shp[0])
        d_height = _dim(f, "JSG_height", shp[1])
        d_bands = _dim(f, "number_of_bands", num_bands)

        lat = _var(f, "latitude", np.float64, (d_along,))
        lon = _var(f, "longitude", np.float64, (d_along,))
        height = _var(f, "height", np.float64, (d_along, d_height))
        for name, v in [("latitude", lat), ("longitude", lon), ("height", height)]:
            for attr in ["units", "long_name", "comment"]:
                if attr in extract_dataset._h5_attrs.get(name, {}):
                    v.attrs[attr] = extract_dataset._h5_attrs[name][attr]
        lat[:] = extract_dataset.lat[:, 0]
        lon[:] = extract_dataset.lon[:, 0]
        height[:] = extract_dataset.alt

        nc_sigma = _var(f, "extinction_coefficient", np.float32, (d_along, d_height, d_bands))
        nc_sigma.attrs.update(units="m^-1", long_name="Extinction coefficient", valid_min=0.0)
        nc_sigma[:] = sigma

        _wgs84_vars(f, extract_dataset.xyz.reshape(shp[0], shp[1], 3), (d_along, d_height))
    finally:
        f.close()


def global_grid_dump(output_filepath: Path, extract_dataset, sigma) -> None:
    """Write a global-grid extract to OpenVDB, or, where the OpenVDB Python
    bindings are missing, to ``<stem>_voxels.npy`` ((N, 3) int32 voxel
    indices) and ``<stem>_sigma.npy`` beside the requested path."""
    sigma = np.asarray(sigma)
    try:
        import openvdb as vdb  # type: ignore
    except ImportError:
        try:
            import pyopenvdb as vdb  # type: ignore
        except ImportError:
            vdb = None
    if vdb is None:
        out = Path(output_filepath)
        voxel_filepath = out.with_name(out.stem + "_voxels.npy")
        sigma_filepath = out.with_name(out.stem + "_sigma.npy")
        warnings.warn(
            "Unable to import OpenVDB Python bindings, exporting to "
            f"{voxel_filepath} and {sigma_filepath} instead."
        )
        for p in (voxel_filepath, sigma_filepath):
            if p.exists():
                warnings.warn(f"overwriting existing extract output {p}")
        np.save(voxel_filepath, extract_dataset.voxels, allow_pickle=False)
        np.save(sigma_filepath, sigma, allow_pickle=False)
        return
    output_filepath = Path(output_filepath)
    if output_filepath.suffix != ".vdb":
        raise ValueError(f"{output_filepath}: an OpenVDB extract needs the .vdb suffix")
    grid = vdb.FloatGrid()
    for i in range(sigma.shape[0]):
        grid.copyFromArray(sigma[i, None, None, None], ijk=extract_dataset.voxels[i])
    grid.transform = vdb.createLinearTransform(voxelSize=extract_dataset.grid_res)
    grid.name = "density"
    grid.saveFloatAsHalf = True
    grid.vectorType = "invariant"
    vdb.write(str(output_filepath), grids=[grid])
