from metal_pathtracer.viewer.server import ViewerServer, main
