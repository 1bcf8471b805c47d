"""The system's own tools, one module for each tool of the repository's
``bin/`` and ``scripts/`` that users run, under the same name:

  sparse_efficiency       the sparse-vs-dense conv sweep (bin/)
  preprocess_fullres_3d   raw simulation file -> labelled 3D training file
  preprocess_fullres_2d   the same for the three 2D wire planes
  file_merge              train/test split of larcv files
  file_premerge           larcv files merged in fixed-size chunks
  calculate_weights       per-label class weights
  voxel_occupancy         active-voxel counts and the suggested capacity
  make_dune3d_file        a dune3d-occupancy synthetic larcv file

Each runs as ``python -m sparseeventid_tpu_torch.scripts.<name>`` with the
arguments and defaults of the tool it ports.  The sweep runs on the card
unless asked for the CPU; the data tools are host work and read and write
HDF5 through h5py (``io/larcv.py``).
"""
